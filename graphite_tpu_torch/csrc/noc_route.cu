// noc_route: the USER net's sends through the emesh_hop_by_hop NoC.
//
// Replaces (XLA unit): graphite_tpu/models/network_hop_by_hop.py
// `route_hop_by_hop` (:123-185) with `_dense_contention` (:188-377), as
// graphite_tpu/engine/step.py:415-423 calls it.  Plain version:
// graphite_tpu_torch/models/network_hop_by_hop.py route_hop_by_hop_plain
// (wrapper ops/noc_route.py).
//
// What it computes: the dense formulation, not the serial per-hop loop.
// Every lane active at a SEND (when models are enabled) routes one packet
// t -> d over XY: the INJECT cell at the source, the horizontal run along
// row sy (RIGHT or LEFT ports), the vertical run along column dx (UP or
// DOWN), the SELF cell at the destination.  Every cell reads the PRE-call
// port state.  A cell's read time is the max-plus closed form of the
// serial recurrence: horizontal cells steps*step + max(base, exclusive
// prefix max of (qt - steps*step)) in the direction of travel, vertical
// cells the same over max(base, the whole horizontal run), SELF over
// everything upstream, base = t0 + router_delay + the inject delay.  The
// prefix takes the raw qt even where a too-old cell's delay falls back to
// M/G/1 (history kinds only; every other kind takes the plain tail).  The
// contention is the sum of every cell's delay.
//
// Design: one cooperative launch of one-warp CTAs, a thread a packet, and
// at least a thread for two port rows (24 CTAs at 256 tiles).
// Phase 1: each thread loads its path cells' queue times, window starts
// and M/G/1 moments into its slice of shared memory (independent loads,
// in flight together), then walks the cells in order in one loop, a running max
// being the exclusive prefix, and folds each cell's member terms into a
// per-port scratch row with 64-bit integer reductions (`red`: max of
// in-window arrivals, sums of processing times, moments, delays, counts).
// Integer reductions commute, so the result does not depend on their
// order; issued from many SMs, and without waiting for a result, they
// are cheap.  (The same walk written as three loops, one a run, lost the
// second vertical cell's accumulation on the card, the cause not found;
// this form is held to the plain version.)
// A grid barrier (arrivals and a generation word after the accumulators)
// ends every read of the queues before any write.
// Phase 2: a thread a port row folds its scratch row into the queue
// (`:332-374`: queue time and window start only when a member is in
// window; newest, moments, requests, utilization, delay and the
// analytical count over every member) and clears the scratch row.  The
// scratch queue row is never touched.
//
// Bound: bytes.  A call reads each lane's five inputs and each path
// cell's queue row, writes each touched row and the latencies: ~175 KB
// at T = 256 in the all-to-all, ~50 ns at 3.35 TB/s; the chain of round
// trips (lane record, the path's rows, M/G/1 moments, the barrier, the
// accumulators, the rows) and the launch set its time.
#include "common.cuh"
#include "net_route.cuh"

#define BLOCK 32          // threads (one warp) a CTA
#define N_PRE 6           // queue columns a path cell reads (QT .. N_ARR)

// Argument block = graphite_tpu_torch/ops/noc_route.py `_pack`.
struct NocArgs {
    const int32_t* op;
    const int32_t* aux0;
    const int32_t* aux1;
    const bool* active;
    const int64_t* clock;
    const bool* enabled;
    int64_t* q;           // [T * 6 + 1, 10]
    long long* scratch;   // [w * h * 6, 9], zero between calls
    int64_t* route_lat;   // [T]
    int64_t T, w, h, router_delay, link_delay, flit_bits, freq_mhz,
        history, analytical, span, contention;
};

// a barrier of the whole grid (co-resident: a cooperative launch), on the
// two words after the accumulators: arrivals and generation
__device__ void grid_barrier(const NocArgs& a, int R) {
    unsigned long long* count =
        (unsigned long long*)(a.scratch + (size_t)R * N_ACC);
    volatile unsigned long long* gen = count + 1;
    __threadfence();              // this thread's atomics are performed
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned long long g = *gen;
        if (atomicAdd(count, 1ull) == gridDim.x - 1) {
            atomicExch(count, 0ull);
            __threadfence();
            atomicAdd((unsigned long long*)gen, 1ull);
        } else {
            while (*gen == g) __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

__global__ void __launch_bounds__(BLOCK) noc_route_kernel(const NocArgs a) {
    extern __shared__ long long cells[];    // [BLOCK][w + h + 2][N_PRE]
    const int T = (int)a.T, w = (int)a.w;
    const int max_cells = w + (int)a.h + 2;
    long long* mine = cells + (size_t)threadIdx.x * max_cells * N_PRE;
    const bool en = *a.enabled;
    const bool hist_ana = a.history && a.analytical;
    const int64_t step = a.router_delay + a.link_delay;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int n_threads = gridDim.x * blockDim.x;

    // phase 1: every packet's path against the pre-call queues
    for (int i = tid; i < T; i += n_threads) {
        const bool live = en && a.active[i] && a.op[i] == OP_SEND;
        const int d = clamp_i32(a.aux0[i], 0, T - 1);
        const int64_t clk = a.clock[i];
        // (64 + payload) * 8 bits in int32, then int64 (the JAX dtypes)
        const int64_t bits = wrap_mul(wrap_add(64, a.aux1[i]), 8);
        int64_t flits = floor_div_i64(bits + a.flit_bits - 1, a.flit_bits);
        if (flits < 1) flits = 1;
        const int64_t t0 = ps_to_cyc(clk, a.freq_mhz);
        const int sx = i % w, sy = i / w, dx = d % w, dy = d / w;
        const int nh = abs(dx - sx), nv = abs(dy - sy);
        const int64_t dist = nh + nv;
        // the path, cell by cell: c = 0 the INJECT cell, 1..nh the
        // horizontal run, nh+1..dist the vertical run, dist+1 SELF; cell c
        // (0 < c <= dist) is c - 1 steps from the source.  First every
        // cell's queue time, window start and moments into this thread's
        // slice of shared memory (independent loads, in flight together),
        // then the walk.
        int64_t cont = 0, base = 0, carry = 0, run = NEG_INF;
        const int n_cells = live && a.contention ? (int)dist + 2 : 0;
        const Path path(w, i, d);
#pragma unroll 8
        for (int c = 0; c < n_cells; ++c) {
            const int64_t* r = a.q + (size_t)path.row(c) * N_COLS;
#pragma unroll
            for (int k = 0; k < N_PRE; ++k) mine[c * N_PRE + k] = r[k];
        }
        for (int c = 0; c < n_cells; ++c) {
            int64_t arr;
            if (c == 0) {
                arr = t0;
            } else if (c <= nh) {
                arr = (c - 1) * step + (base > run ? base : run);
            } else {
                if (c == nh + 1) {   // leaving the horizontal run
                    carry = base > run ? base : run;
                    run = NEG_INF;
                }
                arr = (c <= dist ? (c - 1) * step : dist * step) +
                      (carry > run ? carry : run);
            }
            const int64_t qt = mine[c * N_PRE + COL_QT];
            const int64_t dly = hbh_visit(a.scratch, hist_ana, path.row(c),
                                          mine + c * N_PRE, arr, flits);
            cont += dly;
            if (c == 0) {
                base = t0 + a.router_delay + dly;
            } else if (c <= dist && qt - (c - 1) * step > run) {
                run = qt - (c - 1) * step;
            }
        }
        int64_t lat = 0;
        if (live) {
            const int64_t ser = i == d ? 0 : flits;
            const int64_t t = t0 + a.router_delay + (dist + 1) * step +
                              cont + ser;
            lat = cyc_to_ps(t, a.freq_mhz) - clk;
        }
        a.route_lat[i] = lat;
    }
    if (!a.contention) return;
    const int R = w * (int)a.h * 6;
    grid_barrier(a, R);           // every read of the queues is done

    // phase 2: fold each touched port row into its queue (the
    // accumulators from L2, where the atomics were performed)
    for (int row = tid; row < R; row += n_threads) {
        long long* acc = a.scratch + (size_t)row * N_ACC;
        int64_t v[N_ACC];
#pragma unroll
        for (int k = 0; k < N_ACC; ++k) v[k] = ld_l2(acc + k);
        if (v[A_CNT] == 0) continue;
        hbh_fold_row(a.q + (size_t)row * N_COLS, v, a.span);
#pragma unroll
        for (int k = 0; k < N_ACC; ++k) acc[k] = 0;
    }
}

extern "C" int gt_noc_route(const NocArgs* args, cudaStream_t stream) {
    static_assert(sizeof(NocArgs) == 20 * 8,
                  "NocArgs: 9 pointers and 11 int64");
    // a thread a packet, in CTAs of one warp, so that the accumulators'
    // reductions issue from many SMs, and at least a thread for two port
    // rows; cooperative, for the grid barrier
    const int T = (int)args->T;
    const int R = (int)(args->w * args->h * 6);
    int blocks = (T + BLOCK - 1) / BLOCK;
    const int fold_blocks = (R + 2 * BLOCK - 1) / (2 * BLOCK);
    if (blocks < fold_blocks) blocks = fold_blocks;   // two rows a thread
    const size_t smem = (size_t)BLOCK * (args->w + args->h + 2) * N_PRE *
                        sizeof(long long);
    static size_t smem_set = 48 << 10;     // the default limit
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            noc_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    void* params[] = {(void*)args};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (void*)noc_route_kernel, dim3(blocks), dim3(BLOCK), params, smem,
        stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
