// barrier_sync: barrier init election, arrival, release, split forms.
//
// Replaces (XLA unit): graphite_tpu/engine/step.py:505-577
// (`_barrier_block`: the `_elect_min` scatter-min of barrier inits,
// step.py:136-146, the add-a-delta count set, the arrival scatter-add and
// max-arrival scatter-max, release, the [NB, GEN_RING] generation ring,
// BARRIER_ARRIVE / BARRIER_SYNC, and the reset of released barriers).
// Plain version: graphite_tpu_torch/ops/barrier_sync.py.
//
// Bound: bytes.  ~30 B a lane and 32 B a barrier: ~47 KB an iteration at
// T = 1024, NB = 64 (~14 ns at 3.35 TB/s).  The release needs every
// lane's arrival, so the kernel is ONE CTA (the scatters become shared-
// memory atomics, order-free on integers); its floor is the launch and
// the chain of dependent memory round trips inside that one CTA.
//
// Design: every load at the top, every global write at the end.
//  - Each thread loads its lane's op, aux0, aux1, active, done, clock
//    and waiting once, and the one ring cell ring[bar, aux1 mod 8] that
//    its BARRIER_SYNC output reads (a release patches that cell in
//    registers: only the slot of the new generation changes); in the
//    same pass the [NB] tables are staged in shared memory (32 B a
//    barrier, 32 KB at MAX_BARRIERS: under the 48 KB a launch gets
//    without an opt-in).  Above T = blockDim a stride loop loads the
//    further lanes again in each phase.
//  - Gate on the device, no host read: one __syncthreads_or of the JAX
//    block's gate (some lane active at a barrier op) and of "a staged
//    barrier already has count > 0 && arrived >= count" (never on a
//    real run, where a barrier releases in the iteration its count is
//    reached, but the full path would release it, so it is tested).
//    When neither holds the block is the identity except the non-
//    arrivals' max(time[0], 0) (engine/step.py's module doc): the lanes
//    write their outputs and the kernel ends after one barrier.
//  - The init election and the count set are one atomicMin of the key
//    (tile << 32) | (uint32)aux1: the lowest tile wins, and the key's
//    low half is its aux1.
//  - Arrivals: one shared-memory atomicAdd and atomicMax a lane.  Grouping
//    a warp's arrivals by barrier (__match_any_sync, one leader's atomics
//    a group) was measured 0.15-0.2 us slower with all 1024 lanes at one
//    barrier (PERF.md, PR 3).
//  - The release, the generation ring and the per-lane outputs come
//    from shared memory, with one barrier between the per-barrier and
//    the per-lane part.
#include "common.cuh"

#define MAX_THREADS 1024

// Argument block = graphite_tpu_torch/ops/barrier_sync.py `_pack`.
struct BarrierArgs {
    const int32_t* op;
    const int32_t* aux0;
    const int32_t* aux1;
    const bool* active;
    const bool* done;
    const int64_t* clock;
    int32_t* count;
    int32_t* arrived;
    int64_t* time_ps;
    bool* waiting;
    int32_t* gen;
    int64_t* release_ps;       // [NB, GEN_RING]
    bool* released;
    int64_t* release_time;
    bool* barrive;
    bool* bsync;
    int64_t* bsync_time;
    int64_t T, NB;
};

__device__ __forceinline__ int floor_mod8(int32_t x) {
    return (int)((uint32_t)x & (GEN_RING - 1));    // floor mod, like jnp %
}

// One lane's inputs, as the kernel keeps them in registers.
struct Lane {
    int op, bar, slot;         // slot = aux1 mod GEN_RING (floor)
    int32_t aux1;
    bool act, done, waiting;
    int64_t clock, ring;       // ring = release_ps[bar, slot] as loaded
};

__device__ __forceinline__ Lane load_lane(const BarrierArgs& a, int t,
                                          int NB) {
    Lane l;
    l.op = a.op[t];
    l.bar = clamp_i32(a.aux0[t], 0, NB - 1);
    l.aux1 = a.aux1[t];
    l.act = a.active[t];
    l.done = a.done[t];
    l.waiting = a.waiting[t];
    l.clock = a.clock[t];
    l.slot = floor_mod8(l.aux1);
    l.ring = a.release_ps[(size_t)l.bar * GEN_RING + l.slot];
    return l;
}

__device__ __forceinline__ bool arrive_only(const Lane& l) {
    return l.act && l.op == OP_BARRIER_ARRIVE;
}

__device__ __forceinline__ bool new_arrival(const Lane& l) {
    return (l.act && l.op == OP_BARRIER_WAIT && !l.waiting) ||
           arrive_only(l);
}

__global__ void __launch_bounds__(MAX_THREADS)
barrier_sync_kernel(const BarrierArgs a) {
    const int T = (int)a.T, NB = (int)a.NB;
    extern __shared__ unsigned long long smem[];
    unsigned long long* s_key = smem;                // [NB] init election
    int64_t* s_time = (int64_t*)(smem + NB);         // [NB] max arrival
    int32_t* s_count = (int32_t*)(smem + 2 * NB);    // [NB]
    int32_t* s_arrived = s_count + NB;               // [NB]
    int32_t* s_gen = s_arrived + NB;                 // [NB] new generation
    int32_t* s_rel = s_gen + NB;                     // [NB] released now

    const int tid = threadIdx.x, nt = blockDim.x;
    // the first lane stays in registers; a stride loop reloads the rest
    Lane mine{};
    if (tid < T) mine = load_lane(a, tid, NB);
#define LANE(t, k) ((k) == 0 ? mine : load_lane(a, (t), NB))

    int pred = 0;
    for (int b = tid; b < NB; b += nt) {
        const int32_t c = a.count[b], arr = a.arrived[b];
        s_key[b] = ~0ull;
        s_time[b] = a.time_ps[b];
        s_count[b] = c;
        s_arrived[b] = arr;
        s_gen[b] = a.gen[b];
        pred |= c > 0 && arr >= c;
    }
    for (int t = tid, k = 0; t < T; t += nt, ++k) {
        const Lane l = LANE(t, k);
        pred |= l.act && (l.op == OP_BARRIER_INIT ||
                          l.op == OP_BARRIER_WAIT ||
                          l.op == OP_BARRIER_ARRIVE ||
                          l.op == OP_BARRIER_SYNC);
    }
    if (!__syncthreads_or(pred)) {
        // the identity: no init, no arrival, no release; every lane is a
        // non-arrival, so barrier 0's time is maxed with 0
        const int64_t t0 = s_time[0] < 0 ? 0 : s_time[0];
        if (tid == 0 && s_time[0] < 0) a.time_ps[0] = 0;
        for (int t = tid, k = 0; t < T; t += nt, ++k) {
            const Lane l = LANE(t, k);
            a.released[t] = false;
            a.release_time[t] = l.bar == 0 ? t0 : s_time[l.bar];
            a.barrive[t] = false;
            a.bsync[t] = false;
            a.bsync_time[t] = l.ring;
        }
        return;
    }

    // init election + count (one atomic) and arrivals, one shared-memory
    // atomic a lane (warp-aggregated atomics measured slower, PERF.md)
    int nonarrival = 0;
    for (int t = tid, k = 0; t < T; t += nt, ++k) {
        const Lane l = LANE(t, k);
        if (l.act && l.op == OP_BARRIER_INIT)
            atomicMin(&s_key[l.bar], ((unsigned long long)t << 32) |
                                         (uint32_t)l.aux1);
        if (new_arrival(l)) {
            atomicAdd(&s_arrived[l.bar], 1);
            atomicMax((long long*)&s_time[l.bar], (long long)l.clock);
        } else {
            nonarrival = 1;
        }
    }
    nonarrival = __syncthreads_or(nonarrival);

    // per barrier: count, release, generation ring, reset
    for (int b = tid; b < NB; b += nt) {
        const unsigned long long key = s_key[b];
        const int32_t cnt = key != ~0ull ? (int32_t)(uint32_t)key
                                         : s_count[b];
        int64_t tm = s_time[b];
        if (b == 0 && nonarrival && tm < 0) tm = 0;  // max(., 0): JAX idiom
        const int32_t arr = s_arrived[b];
        const bool rel = cnt > 0 && arr >= cnt;
        const int32_t gen = wrap_add(s_gen[b], rel ? 1 : 0);
        s_time[b] = tm;
        s_gen[b] = gen;
        s_rel[b] = rel;
        if (rel) a.release_ps[(size_t)b * GEN_RING + floor_mod8(gen)] = tm;
        a.count[b] = cnt;
        a.gen[b] = gen;
        a.arrived[b] = rel ? 0 : arr;
        a.time_ps[b] = rel ? 0 : tm;
    }
    __syncthreads();

    // per lane: release and rendezvous outputs
    for (int t = tid, k = 0; t < T; t += nt, ++k) {
        const Lane l = LANE(t, k);
        const bool only = arrive_only(l), arr = new_arrival(l);
        const bool rel = s_rel[l.bar];
        const int32_t gen = s_gen[l.bar];
        const bool participant =
            l.op == OP_BARRIER_WAIT && (l.waiting || arr) && !l.done;
        const bool released = participant && rel;
        a.released[t] = released;
        a.release_time[t] = s_time[l.bar];
        a.waiting[t] = (l.waiting || (arr && !only)) && !released;
        a.barrive[t] = only;
        a.bsync[t] = l.act && l.op == OP_BARRIER_SYNC && gen >= l.aux1;
        // the ring cell after this iteration's release (a lane reloaded
        // above may already see the new value: the same one)
        a.bsync_time[t] = rel && floor_mod8(gen) == l.slot ? s_time[l.bar]
                                                           : l.ring;
    }
#undef LANE
}

extern "C" int gt_barrier_sync(const BarrierArgs* args,
                               cudaStream_t stream) {
    static_assert(sizeof(BarrierArgs) == 19 * 8,
                  "BarrierArgs: 17 pointers and 2 int64");
    const int T = (int)args->T, NB = (int)args->NB;
    const int want = T > NB ? T : NB;
    const int threads = want >= MAX_THREADS ? MAX_THREADS
                                            : (want + 31) / 32 * 32;
    const size_t smem = (size_t)NB * 32;
    barrier_sync_kernel<<<1, threads, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}
