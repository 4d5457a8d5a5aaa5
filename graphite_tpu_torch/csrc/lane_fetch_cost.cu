// lane_fetch_cost: per-lane record fetch, done/active latch and cost.
//
// Replaces (XLA unit): graphite_tpu/engine/step.py:193-241 (record fetch:
// the uniform-column dynamic_slice / per-row gather and the predictor
// read), :242-251 (done latch, active vs qend), :253-272 (the lax_p2p
// hold, in the P2P instantiation) and :342-403 (classify +
// static/branch/dynamic/syscall/BBLOCK cost at the lane's frequency).
// Plain version: graphite_tpu_torch/ops/lane_fetch_cost.py.
//
// Bound: bytes.  One thread a lane reads one record (1+1+8+4+4+8 = 26 B)
// plus ~17 B of lane state and one predictor byte, and writes ~47 B:
// ~93 KB an iteration at T = 1024 (~28 ns at 3.35 TB/s), so the launch
// and the chain of dependent loads are the floor.
//
// Design: one thread a lane, in CTAs of THREADS, every load as early as
// its address is known.
//  - idx, clock, freq, done and the device scalars enabled and qend go
//    out together at the top; the six record loads right after idx; the
//    predictor byte as soon as pc arrives.  That chain, idx -> record ->
//    predictor byte, is three dependent round trips, and this kernel
//    cannot shorten it: the record's address needs this iteration's idx.
//    Removing it means fetching the next record in the previous
//    iteration's commit, which is the loop driver's work (ROADMAP.md
//    queue 2, K4).
//  - Each record column is [T, L], so each lane's load is its own
//    32-byte sector; nothing to coalesce.
//  - The static cost table rides in the argument block (`FetchArgs`,
//    read through the kernel's parameter bank by __grid_constant__), so
//    the cost needs no fourth dependent load.
//  - pc mod bp_size is a mask when bp_size is a power of two (the wrapper
//    decides once, at bind time) and a 32-bit remainder otherwise: pc is
//    the zero-extended uint32 column, never negative.
//
// The lax_p2p hold (entry point gt_lane_fetch_cost_p2p, P2P = true; the
// wrapper picks the entry point at bind time, and the P2P = false body is
// the kernel as it was).  Each lane draws a partner from a uint32 hash of
// (round, tile) and is held when its clock is more than the slack ahead
// of a partner still running after THIS iteration's latch.  That latch is
// written by the partner's own thread, maybe in another CTA, so the
// thread recomputes it instead: done_in[p] or the partner's fetched op
// (t_op[p, idx[p]]) is NOP / THREAD_EXIT.  The partner's clock is the
// pre-commit clock, as in the JAX step.  The round counter is read at the
// top; lane_commit advances it after this kernel has finished.  Partner
// chain: round -> (idx, clock, done_in of p) -> op of p, beside the
// lane's own chain; ~14 B more a lane.
#include "common.cuh"

#define THREADS 64
#define N_COSTS 20

// Argument block = graphite_tpu_torch/ops/lane_fetch_cost.py `_pack`.
struct FetchArgs {
    // lane state
    const int32_t* idx;
    const int64_t* clock;
    const int32_t* freq;
    const bool* done_in;
    const uint8_t* bp_bits;    // [T, B]
    // trace columns, [T, L] each
    const uint8_t* t_op;
    const uint8_t* t_flags;
    const int64_t* t_pc;
    const int32_t* t_aux0;
    const int32_t* t_aux1;
    const int64_t* t_dyn;
    // device scalars
    const bool* enabled;
    const int64_t* qend;
    const int64_t* cost_table;   // bound for identity; `cost` holds it
    // lanes
    int32_t* o_op;
    int32_t* o_flags;
    int64_t* o_pc;
    int32_t* o_aux0;
    int32_t* o_aux1;
    int64_t* o_dyn;
    int32_t* o_bp_index;
    uint8_t* o_bp_pred;
    bool* o_done;
    bool* o_active;
    int64_t* o_cost;
    int64_t T, L, B;
    int64_t bp_mask;           // B - 1 when B is a power of two, else -1
    int64_t bp_enabled, bp_penalty, syscall_rt_ps;
    int64_t cost[N_COSTS];     // static cost cycles by op (op < 20)
};

// Argument block of the P2P entry point = ops/lane_fetch_cost.py
// `_pack_p2p`.
struct P2PArgs {
    FetchArgs f;
    const int32_t* round;      // int32[]: the lax_p2p round counter
    int64_t slack;             // ps
};

template <bool P2P>
__device__ __forceinline__ void fetch_cost(const FetchArgs& a,
                                           const int32_t* round,
                                           int64_t slack) {
    const int T = (int)a.T, L = (int)a.L, B = (int)a.B;
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= T) return;
    const int32_t idx = a.idx[t];
    const int64_t clock = a.clock[t];
    const int64_t f = a.freq[t];
    const bool done_in = a.done_in[t];
    const bool en = *a.enabled;
    const int64_t q = *a.qend;
    const size_t r = (size_t)t * L + clamp_i32(idx, 0, L - 1);
    const int op = a.t_op[r];
    const int flags = a.t_flags[r];
    const int64_t pc = a.t_pc[r];   // zero-extended uint32: 0 <= pc < 2^32
    const int32_t aux0 = a.t_aux0[r];
    const int32_t aux1 = a.t_aux1[r];
    const int64_t dyn = a.t_dyn[r];
    const int bp_index = a.bp_mask >= 0
                             ? (int)(pc & a.bp_mask)
                             : (int)((uint32_t)pc % (uint32_t)B);
    const uint8_t pred = a.bp_bits[(size_t)t * B + bp_index];

    const bool done = done_in || op == OP_NOP || op == OP_THREAD_EXIT;
    bool active = !done && clock < q;
    if constexpr (P2P) {
        uint32_t rnd = (uint32_t)*round * 747796405u +
                       (uint32_t)t * 2891336453u;
        rnd = (rnd ^ (rnd >> 13)) * 1103515245u;
        const uint32_t span = T > 1 ? (uint32_t)(T - 1) : 1u;
        const int p = (int)(((uint32_t)t + 1u + rnd % span) % (uint32_t)T);
        const int32_t p_idx = a.idx[p];
        const int64_t p_clock = a.clock[p];
        const bool p_done_in = a.done_in[p];
        const int p_op = a.t_op[(size_t)p * L + clamp_i32(p_idx, 0, L - 1)];
        const bool p_done =
            p_done_in || p_op == OP_NOP || p_op == OP_THREAD_EXIT;
        if (clock > p_clock + slack && !p_done) active = false;
    }

    int64_t cycles;
    if (op == OP_BRANCH) {
        const uint8_t taken = (flags & FLAG_BRANCH_TAKEN) ? 1 : 0;
        cycles = a.bp_enabled ? (pred == taken ? 1 : a.bp_penalty) : 1;
    } else {
        cycles = a.cost[op < N_COSTS ? op : N_COSTS - 1];
    }
    int64_t cost = ceil_div_i64(cycles * 1000000, f);
    if (op >= OP_DYNAMIC_MISC && op < N_COSTS) cost = dyn;
    if (op >= N_COSTS) cost = 0;
    if (op == OP_SYSCALL || op == OP_DVFS_GET) cost = a.syscall_rt_ps;
    if (op == OP_BBLOCK) cost = ceil_div_i64((int64_t)aux1 * 1000000, f);
    if (!en) cost = 0;

    a.o_op[t] = op;
    a.o_flags[t] = flags;
    a.o_pc[t] = pc;
    a.o_aux0[t] = aux0;
    a.o_aux1[t] = aux1;
    a.o_dyn[t] = dyn;
    a.o_bp_index[t] = bp_index;
    a.o_bp_pred[t] = pred;
    a.o_done[t] = done;
    a.o_active[t] = active;
    a.o_cost[t] = cost;
}

__global__ void __launch_bounds__(THREADS)
lane_fetch_cost_kernel(const __grid_constant__ FetchArgs a) {
    fetch_cost<false>(a, nullptr, 0);
}

__global__ void __launch_bounds__(THREADS)
lane_fetch_cost_p2p_kernel(const __grid_constant__ P2PArgs a) {
    fetch_cost<true>(a.f, a.round, a.slack);
}

extern "C" int gt_lane_fetch_cost(const FetchArgs* args,
                                  cudaStream_t stream) {
    static_assert(sizeof(FetchArgs) == 52 * 8,
                  "FetchArgs: 25 pointers, 7 int64 and 20 costs");
    const int T = (int)args->T;
    lane_fetch_cost_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0,
                             stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int gt_lane_fetch_cost_p2p(const P2PArgs* args,
                                      cudaStream_t stream) {
    static_assert(sizeof(P2PArgs) == 54 * 8,
                  "P2PArgs: FetchArgs, the round pointer and the slack");
    const int T = (int)args->f.T;
    lane_fetch_cost_p2p_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0,
                                 stream>>>(*args);
    return (int)cudaGetLastError();
}
