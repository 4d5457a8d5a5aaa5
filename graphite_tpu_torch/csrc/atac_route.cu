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
// from one thread, when any lane is masked.  The route is
// `atac_route_lane` of net_route.cuh, which the MEMORY net shares.
//
// Bound: bytes.  Five inputs and one output a lane plus the hub rows
// read and written once: ~30 KB at T = 256, ~10 ns at 3.35 TB/s; the
// launch, the staging and five block barriers set the time.
#include "common.cuh"
#include "net_route.cuh"

#define MAX_LANES 1024

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

__global__ void __launch_bounds__(MAX_LANES) atac_route_kernel(
        const AtacArgs a) {
    extern __shared__ long long rows[];
    const NetConsts n{a.q, nullptr, a.freq_mhz, a.flit_bits, a.history,
                      a.analytical, a.span, a.contention, a.w, 0, 0, 0,
                      a.C, a.cw, a.ch, a.enet_hop, a.send_hub, a.recv_hub,
                      a.from_hub_ps, a.optical_ps, a.distance_based,
                      a.threshold};
    const int T = (int)a.T;
    const int t = threadIdx.x;
    const bool valid = t < T;
    bool mask = false;
    int d = 0;
    int64_t clk = 0, flits = 0;
    if (valid) {
        mask = a.active[t] && a.op[t] == OP_SEND;
        d = clamp_i32(a.aux0[t], 0, T - 1);
        clk = a.clock[t];
        // (64 + payload) * 8 bits, the flit count in int32, then int64
        const int32_t bits = wrap_mul(wrap_add(64, a.aux1[t]), 8);
        flits = floor_div_i32(wrap_add(bits, (int32_t)a.flit_bits - 1),
                              (int32_t)a.flit_bits);
    }
    if (a.contention) atac_stage(n, rows);
    const int64_t lat = atac_route_lane(n, rows, valid, valid ? t : 0, d,
                                        flits, clk, mask, *a.enabled);
    if (a.contention) atac_commit(n, rows);
    if (valid) a.route_lat[t] = lat;
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
