// atac_route: the USER net's sends through the ATAC optical NoC.
//
// Replaces (XLA unit): graphite_tpu/models/network_atac.py `route_atac`
// (:176-243) with its two graphite_tpu/models/queue_models.py
// `scatter_queue_delay` calls (:277-346), as graphite_tpu/engine/
// step.py:424-431 calls it.  Plain version: graphite_tpu_torch/models/
// network_atac.py route_atac_plain (wrapper ops/atac_route.py).
//
// Per lane t active at a SEND (dst d = clip(aux0)): the clusters of t and
// d, t's optical hub, the ENet hop counts, and whether the packet rides
// the ONet (`cluster_based`: every inter-cluster unicast; `distance_
// based`: those longer than the threshold).  ENet: hops x (router + link)
// cycles.  ONet: ENet to the hub, the send hub's queue and router, the
// waveguide, the receive hub's queue and router, the receive net.  Then
// receive-side serialization (none for a self-send); everything 0 while
// models are disabled.
//
// The two hub-queue calls keep `scatter_queue_delay`'s order: every lane
// reads its row of the PRE-call state (delay: the tail, or M/G/1 for a
// too-old packet of a history queue); then a scatter-max of the in-window
// arrival into the queue time (0 for a lane not in window; masked lanes
// go to the scratch row), a barrier, a scatter-add of the in-window
// processing times, a barrier; then the window start from the POST-commit
// queue time, the newest arrival and the moment and counter sums.  The
// receive-hub call reads the state the send-hub call committed.
//
// Design: one CTA, one thread a lane (at most 1,024 lanes).  The hub
// queues ((2C + 1) x 80 B: 10 KB for the 129 queues of 256 tiles in
// clusters of four, 41 KB at 1,024 tiles) are staged in shared memory, the
// scatters are shared-memory 64-bit atomics (integer max and add commute,
// so results do not depend on their order), block barriers order the
// phases, and the rows are written back at the end.  The scratch row
// takes the masked lanes' terms (max with 0, with -2^62 and with 0) once,
// from one thread, when any lane is masked.
//
// Bound: bytes.  Five inputs and one output a lane plus the hub rows
// read and written once: ~30 KB at T = 256, ~10 ns at 3.35 TB/s; the
// launch, the staging and five block barriers set the time.
#include "common.cuh"
#include "queue_common.cuh"

#define MAX_LANES 1024
#define WIN_FLOOR (-(1LL << 62))

// Argument block = graphite_tpu_torch/ops/atac_route.py `_pack`.
struct AtacArgs {
    const int32_t* op;
    const int32_t* aux0;
    const int32_t* aux1;
    const bool* active;
    const int64_t* clock;
    const bool* enabled;
    int64_t* q;            // [2C + 1, 10]: send hubs, receive hubs, scratch
    int64_t* route_lat;    // [T]
    int64_t T, C, w, cw, ch, flit_bits, freq_mhz, enet_hop, send_hub,
        recv_hub, from_hub_ps, optical_ps, distance_based, threshold,
        history, analytical, span, contention;
};

struct Lane {
    bool valid;     // a thread with a lane (t < T)
    bool mask;      // this call's mask (the lane rides the ONet, live)
    int qid;        // its hub row (the scratch row when masked)
    int64_t pkt;    // arrival at the hub, network cycles
    int64_t proc;   // processing (serialization) cycles, >= 1
};

// shared-memory 64-bit integer atomics on long long words (int64_t is
// `long`, another type: the staged rows are declared long long)
__device__ __forceinline__ void atomic_add_ll(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

__device__ __forceinline__ void atomic_max_ll(long long* p, long long v) {
    atomicMax(p, v);
}

// `scatter_queue_delay` over the staged rows; every thread of the block
// calls it (the barriers).  Returns the lane's delay (0 when masked).
__device__ int64_t scatter_delay(const AtacArgs& a, long long* rows,
                                 const Lane& ln) {
    long long* r = rows + ln.qid * N_COLS;
    int64_t delay = 0;
    bool too_old = false;
    if (ln.valid) {
        const int64_t qt = r[COL_QT];
        if (a.history && a.analytical) too_old = ln.pkt + ln.proc < r[COL_WS];
        delay = too_old ? mg1_wait(r[COL_N_ARR], r[COL_SUM_ST],
                                   r[COL_SUM_ST2], r[COL_NEWEST])
                        : (qt - ln.pkt > 0 ? qt - ln.pkt : 0);
    }
    const bool in_win = ln.mask && !too_old;
    // every lane's read of the pre-call row is done; the masked lanes'
    // terms all land on the scratch row
    const int any_masked = __syncthreads_or(ln.valid && !ln.mask);
    if (ln.mask) atomic_max_ll(r + COL_QT, in_win ? ln.pkt : 0);
    __syncthreads();
    if (in_win) atomic_add_ll(r + COL_QT, ln.proc);
    __syncthreads();
    if (ln.mask) {
        const int64_t qt_new = r[COL_QT];
        atomic_max_ll(r + COL_WS, in_win ? qt_new - a.span : WIN_FLOOR);
        atomic_max_ll(r + COL_NEWEST, ln.pkt + delay + ln.proc);
        atomic_add_ll(r + COL_SUM_ST, ln.proc);
        atomic_add_ll(r + COL_SUM_ST2, ln.proc * ln.proc);
        atomic_add_ll(r + COL_N_ARR, 1);
        atomic_add_ll(r + COL_REQS, 1);
        atomic_add_ll(r + COL_UTIL, ln.proc);
        atomic_add_ll(r + COL_DELAY, delay);
        if (too_old) atomic_add_ll(r + COL_ANA, 1);
    }
    if (any_masked && threadIdx.x == 0) {
        long long* s = rows + 2 * a.C * N_COLS;
        if (s[COL_QT] < 0) s[COL_QT] = 0;
        if (s[COL_WS] < WIN_FLOOR) s[COL_WS] = WIN_FLOOR;
        if (s[COL_NEWEST] < 0) s[COL_NEWEST] = 0;
    }
    __syncthreads();
    return ln.mask ? delay : 0;
}

__device__ __forceinline__ int enet_hops(int a, int b, int w) {
    return abs(a % w - b % w) + abs(a / w - b / w);
}

__global__ void __launch_bounds__(MAX_LANES) atac_route_kernel(
        const AtacArgs a) {
    extern __shared__ long long rows[];
    const int T = (int)a.T, w = (int)a.w, C = (int)a.C;
    const int n_words = (2 * C + 1) * N_COLS;
    if (a.contention) {
        for (int k = threadIdx.x; k < n_words; k += blockDim.x)
            rows[k] = a.q[k];
    }
    const int t = threadIdx.x;
    const bool valid = t < T;
    const bool en = *a.enabled;
    bool mask = false, use_onet = false;
    int d = 0, csrc = 0, cdst = 0;
    int64_t clk = 0, flits = 0;
    if (valid) {
        mask = a.active[t] && a.op[t] == OP_SEND;
        d = clamp_i32(a.aux0[t], 0, T - 1);
        clk = a.clock[t];
        // (64 + payload) * 8 bits, the flit count in int32, then int64
        const int32_t bits = wrap_mul(wrap_add(64, a.aux1[t]), 8);
        flits = floor_div_i32(wrap_add(bits, (int32_t)a.flit_bits - 1),
                              (int32_t)a.flit_bits);
        const int per_row = w / (int)a.cw;
        csrc = (t / w) / (int)a.ch * per_row + (t % w) / (int)a.cw;
        cdst = (d / w) / (int)a.ch * per_row + (d % w) / (int)a.cw;
        bool enet = csrc == cdst;
        if (a.distance_based) enet = enet || enet_hops(t, d, w) <= a.threshold;
        use_onet = mask && !enet;
    }
    const bool onet_live = use_onet && en;
    const int per_row = w / (int)a.cw;
    const int hub = (csrc / per_row) * (int)a.ch * w + (csrc % per_row) *
                    (int)a.cw;
    const int64_t sendhub_arrive =
        clk + cyc_to_ps((int64_t)enet_hops(t, hub, w) * a.enet_hop,
                        a.freq_mhz);
    const int64_t proc = flits > 1 ? flits : 1;
    int64_t delay1 = 0, delay2 = 0;
    if (a.contention) {
        __syncthreads();                       // the rows are staged
        const Lane l1{valid, onet_live, onet_live ? csrc : 2 * C,
                      ps_to_cyc(sendhub_arrive, a.freq_mhz), proc};
        delay1 = scatter_delay(a, rows, l1);
    }
    const int64_t recvhub_arrive =
        sendhub_arrive + cyc_to_ps(delay1 + a.send_hub, a.freq_mhz) +
        (en ? a.optical_ps : 0);
    if (a.contention) {
        const Lane l2{valid, onet_live, onet_live ? C + cdst : 2 * C,
                      ps_to_cyc(recvhub_arrive, a.freq_mhz), proc};
        delay2 = scatter_delay(a, rows, l2);
        for (int k = threadIdx.x; k < n_words; k += blockDim.x)
            a.q[k] = rows[k];
    }
    if (!valid) return;
    const int64_t recvhub_done =
        recvhub_arrive + cyc_to_ps(delay2 + a.recv_hub, a.freq_mhz);
    const int64_t onet_ps = (recvhub_done - clk) + a.from_hub_ps;
    const int64_t enet_ps =
        cyc_to_ps((int64_t)enet_hops(t, d, w) * a.enet_hop, a.freq_mhz);
    const int64_t ser_ps = t == d ? 0 : cyc_to_ps(flits, a.freq_mhz);
    const int64_t total = en ? (use_onet ? onet_ps : enet_ps) + ser_ps : 0;
    a.route_lat[t] = mask ? total : 0;
}

extern "C" int gt_atac_route(const AtacArgs* args, cudaStream_t stream) {
    static_assert(sizeof(AtacArgs) == 26 * 8,
                  "AtacArgs: 8 pointers and 18 int64");
    const int T = (int)args->T;
    const size_t smem = args->contention
        ? (size_t)(2 * args->C + 1) * N_COLS * sizeof(int64_t) : 0;
    static size_t smem_set = 48 << 10;
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            atac_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    int threads = ((T + 31) / 32) * 32;
    if (threads > MAX_LANES) threads = MAX_LANES;
    atac_route_kernel<<<1, threads, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}
