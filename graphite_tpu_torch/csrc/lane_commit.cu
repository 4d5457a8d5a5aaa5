// lane_commit: per-lane commit of one subquantum iteration.
//
// Replaces (XLA unit): graphite_tpu/engine/step.py:842-915 (the advance
// mask and the clock's max/where chain, with the memory subsystem's
// mem_ok and latency and the iocoom tiles' clock), :999-1066 (plain-run
// batching: the [T, KX] follow-on gather, cumsum against qend and
// cumprod), :1098-1140 + :1141-1151 + :1204 (the counters, the one-bit
// predictor write, the network counters, the progress sum) and
// :1179-1180 (the memory slot reset of a committed record).  Plain
// version: graphite_tpu_torch/ops/lane_commit.py.
//
// The memory and iocoom inputs are optional pointers: the memoryless
// simple core passes them null and launches the MODELS = false
// instantiation, the kernel as it was before they existed.
//
// Under lax_p2p the round counter (`p2p_round`, int32[], the JAX step's
// :270 and :1195) goes up by one an iteration, wrapping like int32: one
// thread adds it here, after lane_fetch_cost, which read it, has finished
// (the launches are stream-ordered).  Null under the other schemes.
//
// Design: one thread a lane, in CTAs of THREADS = 64 so that the lanes'
// loads spread over 16 SMs at T = 1024, with no load behind another that
// need not be:
//  - every per-lane input and counter is loaded at the top, so the loads
//    go out together;
//  - the follow-on window [i0 + 1, i0 + KX] of the lane's trace row (an
//    uncoalesced row: the stride is L bytes) comes in as the (at most)
//    two aligned 16-byte words that cover it, clipped at L, right after
//    idx; the stop-at-first-non-PLAIN / qend scan (the JAX cumsum +
//    cumprod) then runs on those bytes in registers.  An aligned word
//    that holds a byte of the row lies inside the tensor's allocation;
//    the bytes outside the window are masked;
//  - a committed follow-on record's cost in ps is its static cost (from
//    the 160-byte table, which every lane reads through the read-only
//    cache) divided by the lane's post-DVFS frequency;
//  - the predictor write touches only the lane's own (t, pc mod bp_size)
//    cell.  The advanced lanes are counted per block
//    (__syncthreads_count) and added to the device progress counter the
//    loop driver reads once a block of iterations; an integer add, so
//    the order of the atomics cannot change the sum.
//
// Bound: bytes.  ~200 B of per-lane inputs and counters read and ~100 B
// written, plus up to KX = 15 trace bytes: ~300 KB an iteration at
// T = 1024 (~0.1 us at 3.35 TB/s); launch latency is the floor.
#include "common.cuh"

#define THREADS 64
#define KX_MAX 15       // = graphite_tpu_torch/ops/lane_commit.py MAX_FOLLOW

// Argument block = graphite_tpu_torch/ops/lane_commit.py `_pack`.
struct CommitArgs {
    const uint8_t* trace_op;
    // lanes
    const int32_t* op;
    const int32_t* flags;
    const int32_t* aux0;
    const int64_t* dyn_ps;
    const int32_t* bp_index;
    const uint8_t* bp_pred;
    const bool* done_new;
    const bool* active;
    const int64_t* cost_ps;
    const bool* recv_now;
    const int64_t* recv_time;
    const int32_t* recv_lat;
    const bool* released;
    const int64_t* release_time;
    const bool* barrive_now;
    const bool* bsync_now;
    const int64_t* bsync_time;
    const bool* granted;
    const int64_t* mutex_wait_ps;
    const bool* cond_post_commit;
    const bool* pub_now;
    const bool* cjoin_now;
    const int64_t* cjoin_time;
    const bool* join_now;
    const int64_t* join_time;
    const int32_t* freq_new;
    const bool* en_post;
    int32_t* progress;
    // core
    int64_t* clock;
    int32_t* idx;
    int32_t* freq;
    int64_t* instruction_count;
    int64_t* execution_stall_ps;
    int64_t* recv_instructions;
    int64_t* recv_stall_ps;
    int64_t* sync_instructions;
    int64_t* sync_stall_ps;
    int64_t* bp_correct;
    int64_t* bp_incorrect;
    uint8_t* bp_bits;
    // net counters
    int64_t* packets_sent;
    int64_t* packets_received;
    int64_t* total_latency_ps;
    // state
    bool* done;
    const bool* enabled;
    const int64_t* qend;
    const int64_t* cost_table;
    int32_t* p2p_round;        // null unless lax_p2p
    // memory subsystem (null without one)
    const bool* mem_ok;
    int32_t* req_slot;
    int64_t* req_acc;          // read (the record's latency), then reset
    int64_t* req_slot_lat;     // [T, 3]
    // iocoom tiles (null without the iocoom core)
    const bool* ioc_tile;
    const int64_t* ioc_clock;
    const int64_t* ioc_mem_stall;
    const int64_t* ioc_exec_stall;
    int64_t* memory_stall;     // null for the memoryless simple core
    int64_t T, L, B, KX;
};

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
    return a > b ? a : b;
}

// The KX_MAX bytes at p (clipped to n of them; the rest read OP_NOP),
// from the at most two aligned 16-byte words that cover them.
__device__ __forceinline__ void load_window(const uint8_t* p, int n,
                                            uint8_t (&win)[KX_MAX]) {
    const uintptr_t addr = (uintptr_t)p;
    const int off = (int)(addr & 15);
    const uint4* w = (const uint4*)(addr - off);
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (n > 0) lo = __ldg(w);
    if (off + n > 16) hi = __ldg(w + 1);
    const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    // v = x shifted down by off / 4 words (a select, not an indexed read)
    const int q = off >> 2;
    uint32_t v[5];
#pragma unroll
    for (int j = 0; j < 5; ++j)
        v[j] = q == 0 ? x[j] : q == 1 ? x[j + 1] : q == 2 ? x[j + 2]
                                                         : x[j + 3];
    const int sh = (off & 3) * 8;
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __funnelshift_r(v[j], v[j + 1], sh);
#pragma unroll
    for (int k = 0; k < KX_MAX; ++k)
        win[k] = k < n ? (uint8_t)(u[k >> 2] >> ((k & 3) * 8)) : OP_NOP;
}

// MODELS: the run has a memory subsystem or the iocoom core (the nine
// optional pointers are read); without, the memoryless instantiation is
// the kernel as it was before they existed.
template <bool MODELS>
__global__ void __launch_bounds__(THREADS)
lane_commit_kernel(const CommitArgs a) {
    const int T = (int)a.T, L = (int)a.L, B = (int)a.B, KX = (int)a.KX;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = t < T;
    const int u = live ? t : T - 1;        // in bounds; discarded if !live

    // every load first
    const int op = a.op[u];
    const bool act = a.active[u];
    const int32_t flags = a.flags[u], aux0 = a.aux0[u];
    const int64_t dyn = a.dyn_ps[u], cost = a.cost_ps[u];
    const int32_t bp_index = a.bp_index[u];
    const uint8_t bp_pred = a.bp_pred[u];
    const bool done_new = a.done_new[u];
    const bool recv_now = a.recv_now[u], released = a.released[u];
    const bool granted = a.granted[u], join_now = a.join_now[u];
    const bool bsync = a.bsync_now[u], cjoin = a.cjoin_now[u];
    const bool others = a.cond_post_commit[u] | a.barrive_now[u] |
                        a.pub_now[u];
    const int64_t recv_time = a.recv_time[u];
    const int32_t recv_lat = a.recv_lat[u];
    const int64_t release_time = a.release_time[u];
    const int64_t bsync_time = a.bsync_time[u];
    const int64_t mutex_wait = a.mutex_wait_ps[u];
    const int64_t cjoin_time = a.cjoin_time[u], join_time = a.join_time[u];
    const int32_t fnew = a.freq_new[u];
    const int64_t clock0 = a.clock[u];
    const int32_t idx = a.idx[u];
    const int64_t n_instr = a.instruction_count[u];
    const int64_t n_exec = a.execution_stall_ps[u];
    const int64_t n_recv_i = a.recv_instructions[u];
    const int64_t n_recv_s = a.recv_stall_ps[u];
    const int64_t n_sync_i = a.sync_instructions[u];
    const int64_t n_sync_s = a.sync_stall_ps[u];
    const int64_t n_bp_ok = a.bp_correct[u], n_bp_bad = a.bp_incorrect[u];
    const int64_t n_sent = a.packets_sent[u];
    const int64_t n_recvd = a.packets_received[u];
    const int64_t n_lat = a.total_latency_ps[u];
    const bool en_post = *a.en_post, en = *a.enabled;
    const int64_t q = *a.qend;
    const bool has_mem = MODELS && a.req_acc != nullptr;
    const bool has_ioc = MODELS && a.ioc_tile != nullptr;
    const bool mem_ok = has_mem ? a.mem_ok[u] : true;
    const int64_t mem_acc = has_mem ? a.req_acc[u] : 0;
    const bool ioc = has_ioc && a.ioc_tile[u];
    const int64_t ioc_clock = has_ioc ? a.ioc_clock[u] : 0;
    const int64_t ioc_mem = has_ioc ? a.ioc_mem_stall[u] : 0;
    const int64_t ioc_exec = has_ioc ? a.ioc_exec_stall[u] : 0;
    const int64_t n_mem = (MODELS && a.memory_stall) ? a.memory_stall[u]
                                                      : 0;
    const int i0 = clamp_i32(idx, 0, L - 1);
    uint8_t win[KX_MAX];
    load_window(a.trace_op + (size_t)u * L + i0 + 1,
                min(KX, L - 1 - i0), win);

    const bool is_branch = op == OP_BRANCH;
    const bool is_static = op < OP_DYNAMIC_MISC && !is_branch;
    const bool is_dynamic = op >= OP_DYNAMIC_MISC && op < 20;
    const bool is_spawn = op == OP_SPAWN;
    const bool is_send = op == OP_SEND;
    const bool is_bblock = op == OP_BBLOCK;
    const bool simple_event =
        op == OP_THREAD_SPAWN || op == OP_BARRIER_INIT ||
        op == OP_MUTEX_INIT || op == OP_MUTEX_UNLOCK ||
        op == OP_ENABLE_MODELS || op == OP_DISABLE_MODELS ||
        op == OP_DVFS_SET || op == OP_DVFS_GET || op == OP_SYSCALL ||
        op == OP_COND_INIT;
    const bool dyn_plain = is_dynamic && !is_spawn;
    const bool instr_like = is_static || is_branch;
    // an instruction record with memory slots commits once they completed
    const bool costed = ((instr_like || is_bblock) && mem_ok) || dyn_plain ||
                        simple_event || is_send;
    const bool advance = live &&
        ((act && costed) || recv_now || released || (act && is_spawn) ||
         granted || join_now || others || bsync || cjoin);
    // an iocoom tile's instruction record takes iocoom_commit's clock
    const bool simple_instr = instr_like && !ioc;
    const bool mem_paid = simple_instr || is_bblock;

    int64_t c = (advance && (mem_paid || dyn_plain || simple_event || is_send))
                    ? clock0 + cost + (mem_paid ? mem_acc : 0)
                    : clock0;
    if (advance && instr_like && ioc) c = ioc_clock;
    if (act && is_spawn) c = max64(c, dyn);
    if (recv_now) c = max64(c, recv_time);
    if (released) c = max64(c, release_time);
    if (granted) c = c + mutex_wait;
    if (join_now) c = join_time;
    if (bsync) c = max64(c, bsync_time);
    if (cjoin) c = max64(c, cjoin_time);

    // plain-run batching over the window, at the post-DVFS frequency:
    // commit while every record so far is PLAIN (a static non-branch op)
    // and starts before qend
    int extra_n = 0;
    int64_t extra_cost = 0;
    bool run = advance;
#pragma unroll
    for (int k = 0; k < KX_MAX; ++k) {
        const int o = win[k];
        run = run && o <= OP_MFENCE && o != OP_BRANCH && c + extra_cost < q;
        if (run) {
            if (en_post)
                extra_cost += ceil_div_i64(__ldg(a.cost_table + o) * 1000000,
                                           (int64_t)fnew);
            ++extra_n;
        }
    }

    if (live) {
        const int64_t recv_wait = recv_now ? max64(recv_time - clock0, 0)
                                           : 0;
        const int64_t barrier_wait =
            released ? max64(release_time - clock0, 0) : 0;
        const int64_t bsync_wait = bsync ? max64(bsync_time - clock0, 0) : 0;
        const int64_t cjoin_wait = cjoin ? max64(cjoin_time - clock0, 0) : 0;
        const bool instr_now =
            advance && (is_static || is_branch || dyn_plain);
        const bool recv_charged = recv_now && recv_wait > 0 && en;
        const bool sync_charged =
            ((released && barrier_wait > 0) || (granted && mutex_wait > 0) ||
             (bsync && bsync_wait > 0) || (cjoin && cjoin_wait > 0)) && en;

        a.clock[t] = c + extra_cost;
        a.freq[t] = fnew;
        a.idx[t] = wrap_add(idx, (advance ? 1 : 0) + extra_n);
        a.instruction_count[t] =
            n_instr + (int64_t)(instr_now && en) + (en_post ? extra_n : 0) +
            ((advance && is_bblock && en) ? (int64_t)aux0 : 0) +
            (int64_t)recv_charged + (int64_t)sync_charged;
        a.execution_stall_ps[t] =
            n_exec + extra_cost + ((advance && mem_paid) ? cost : 0) +
            ioc_exec;
        if (MODELS && a.memory_stall)
            a.memory_stall[t] =
                n_mem + ((advance && mem_paid) ? mem_acc : 0) + ioc_mem;
        if (has_mem && advance) {
            a.req_slot[t] = 0;
            a.req_acc[t] = 0;
            a.req_slot_lat[(size_t)t * 3] = 0;
            a.req_slot_lat[(size_t)t * 3 + 1] = 0;
            a.req_slot_lat[(size_t)t * 3 + 2] = 0;
        }
        a.recv_instructions[t] = n_recv_i + (int64_t)recv_charged;
        a.recv_stall_ps[t] = n_recv_s + (recv_charged ? recv_wait : 0);
        a.sync_instructions[t] = n_sync_i + (int64_t)sync_charged;
        a.sync_stall_ps[t] = n_sync_s +
                             ((released && en) ? barrier_wait : 0) +
                             ((granted && en) ? mutex_wait : 0) +
                             (en ? bsync_wait + cjoin_wait : 0);
        if (act && is_branch && en) {
            const uint8_t taken = (flags & FLAG_BRANCH_TAKEN) ? 1 : 0;
            a.bp_bits[(size_t)t * B + bp_index] = taken;
            if (bp_pred == taken)
                a.bp_correct[t] = n_bp_ok + 1;
            else
                a.bp_incorrect[t] = n_bp_bad + 1;
        }
        a.packets_sent[t] = n_sent + (int64_t)(act && is_send);
        a.packets_received[t] = n_recvd + (int64_t)recv_now;
        a.total_latency_ps[t] = n_lat + (recv_now ? (int64_t)recv_lat : 0);
        a.done[t] = done_new;
    }
    const int n = __syncthreads_count(advance);
    if (threadIdx.x == 0 && n > 0) atomicAdd(a.progress, n);
    if (a.p2p_round && blockIdx.x == 0 && threadIdx.x == 0)
        *a.p2p_round = wrap_add(*a.p2p_round, 1);
}

extern "C" int gt_lane_commit(const CommitArgs* args,
                              cudaStream_t stream) {
    static_assert(sizeof(CommitArgs) == 62 * 8,
                  "CommitArgs: 58 pointers and 4 int64");
    const int T = (int)args->T;
    const int blocks = (T + THREADS - 1) / THREADS;
    if (args->memory_stall)
        lane_commit_kernel<true><<<blocks, THREADS, 0, stream>>>(*args);
    else
        lane_commit_kernel<false><<<blocks, THREADS, 0, stream>>>(*args);
    return (int)cudaGetLastError();
}
