// iocoom_commit: one committing record per lane through the IOCOOM
// pipeline algebra (in-order commit, out-of-order memory).
//
// Replaces (XLA unit): graphite_tpu/models/iocoom.py:129-330
// (`iocoom_commit`: instruction fetch, the register scoreboard, the
// store-queue bypass and the load-queue ring, execution, the write
// register, the store-queue ring ordered after the last load, the clock
// advance and the seven stall counters) and the heterogeneous
// `iocoom_tiles` mask of graphite_tpu/engine/step.py:856-900.  Plain
// version: graphite_tpu_torch/ops/iocoom_commit.py.
//
// Bound: bytes.  A committing lane reads ~60 B of lane state, two
// scoreboard entries (9 B each), its load and store rings (8 + 8 + 8
// entries, ~200 B) and writes one scoreboard entry, at most two ring
// entries and its counters: ~300 KB an iteration at T = 1024 if every
// lane commits.
//
// Design: one thread a lane, in CTAs of THREADS; a lane reads and writes
// only its own scoreboard row and rings, so nothing is shared.  The
// trace's register and address columns are read at the lane's record
// here (the fetch kernel does not carry them).  Without a memory
// subsystem the addresses and slot latencies are null and read as 0, as
// in the JAX step.
#include "common.cuh"

#define THREADS 64
#define NUM_REGISTERS 512
#define NO_REG 0xFFFF
#define UNIT_LOAD 1
#define UNIT_EXEC 3
#define FLAG_MEM0_VALID 1
#define FLAG_MEM1_VALID 2
#define FLAG_MEM0_WRITE 4
#define FLAG_MEM1_WRITE 8
#define FLAG_SIMPLE_MOV_LOAD 128

// Argument block = graphite_tpu_torch/ops/iocoom_commit.py `_pack`.
struct IocArgs {
    const int32_t* op;
    const int32_t* flags;
    const bool* active;
    const int64_t* cost_ps;
    const bool* mem_ok;
    int64_t* ioc_clock;
    int64_t* ioc_mem_stall;
    int64_t* ioc_exec_stall;
    const bool* ioc_tile;
    const int32_t* idx;
    const int64_t* clock;
    const int32_t* freq;
    const int32_t* rreg0;      // [T, L]
    const int32_t* rreg1;
    const int32_t* wreg;
    const int64_t* addr0;      // [T, L] or null
    const int64_t* addr1;
    const int64_t* slot_lat;   // [T, 3] or null
    const bool* enabled;
    int64_t* reg_ready;        // [T, NUM_REGISTERS]
    uint8_t* reg_unit;
    int64_t* lq;               // [T, LQ]
    int32_t* lq_idx;
    int64_t* sq;               // [T, SQ]
    int32_t* sq_addr;
    int32_t* sq_idx;
    int64_t* load_queue;
    int64_t* store_queue;
    int64_t* l1icache;
    int64_t* intra_l1d;
    int64_t* inter_l1d;
    int64_t* intra_exec;
    int64_t* inter_exec;
    int64_t T, L, LQ, SQ, speculative, multi_rfo;
};

__device__ __forceinline__ int64_t mx(int64_t a, int64_t b) {
    return a > b ? a : b;
}

__device__ __forceinline__ int ring(int64_t i, int64_t n) {
    const int64_t r = i % n;
    return (int)(r < 0 ? r + n : r);
}

__global__ void __launch_bounds__(THREADS)
iocoom_commit_kernel(const IocArgs a) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= a.T) return;
    const int op = a.op[t];
    const int64_t clock = a.clock[t];
    const bool commit = a.active[t] && op < OP_DYNAMIC_MISC && a.mem_ok[t] &&
                        a.ioc_tile[t] && *a.enabled;
    if (!commit) {
        a.ioc_clock[t] = clock;
        a.ioc_mem_stall[t] = 0;
        a.ioc_exec_stall[t] = 0;
        return;
    }
    const int flags = a.flags[t];
    const int64_t one = ceil_div_i64(1000000LL, (int64_t)a.freq[t]);
    const int64_t L = a.L, LQ = a.LQ, SQ = a.SQ;
    const size_t rec = (size_t)t * L + min(a.idx[t], (int)L - 1);
    const int64_t* sl = a.slot_lat ? a.slot_lat + (size_t)t * 3 : nullptr;
    const int64_t lat0 = sl ? sl[0] : 0, lat1 = sl ? sl[1] : 0,
                  lat2 = sl ? sl[2] : 0;
    const int32_t line0 = a.addr0 ? (int32_t)(a.addr0[rec] >> 6) : 0;
    const int32_t line1 = a.addr1 ? (int32_t)(a.addr1[rec] >> 6) : 0;

    const int64_t icache_lat = lat0 >= one ? lat0 - one : lat0;
    const int64_t instruction_ready = clock + icache_lat;
    int64_t ld[2], ex[2];
    const int32_t rr[2] = {a.rreg0[rec], a.rreg1[rec]};
    for (int k = 0; k < 2; ++k) {
        const size_t e = (size_t)t * NUM_REGISTERS +
                         clamp_i32(rr[k], 0, NUM_REGISTERS - 1);
        const bool valid = rr[k] != NO_REG;
        const int unit = a.reg_unit[e];
        const int64_t ready = a.reg_ready[e];
        ld[k] = valid && unit == UNIT_LOAD ? ready : 0;
        ex[k] = valid && unit == UNIT_EXEC ? ready : 0;
    }
    const int64_t ready_load = mx(instruction_ready, mx(ld[0], ld[1]));
    const int64_t ready_exec = mx(instruction_ready, mx(ex[0], ex[1]));
    const int64_t reg_ops = mx(ready_load, ready_exec);

    const bool m0v = flags & FLAG_MEM0_VALID, m1v = flags & FLAG_MEM1_VALID;
    const bool m0w = flags & FLAG_MEM0_WRITE, m1w = flags & FLAG_MEM1_WRITE;
    const bool smov = flags & FLAG_SIMPLE_MOV_LOAD;

    // loads: the store-queue bypass, else the load-queue ring
    int64_t* lq = a.lq + (size_t)t * LQ;
    const int64_t* sq0 = a.sq + (size_t)t * SQ;
    const int32_t* sqa = a.sq_addr + (size_t)t * SQ;
    int32_t lq_idx = a.lq_idx[t];
    int64_t lq_ready = reg_ops, mem_ready = reg_ops;
    const int32_t lines[2] = {line0, line1};
    const int64_t lats[2] = {lat1, lat2};
    const bool loads[2] = {m0v && !m0w, m1v && !m1w};
    for (int k = 0; k < 2; ++k) {
        if (!loads[k]) continue;
        const int64_t sched = reg_ops;
        bool byp = false;
        for (int q = 0; q < SQ; ++q)
            byp |= sqa[q] == lines[k] && sq0[q] >= sched;
        const int64_t head = lq[ring(lq_idx, LQ)];
        const int64_t last = lq[ring((int64_t)lq_idx + LQ - 1, LQ)];
        int64_t alloc = mx(head, sched), completion, dealloc;
        if (a.speculative) {
            completion = alloc + lats[k] + one;
            dealloc = mx(completion, last + one);
        } else {
            completion = mx(last, sched) + lats[k] + one;
            dealloc = completion;
        }
        if (byp) {
            alloc = sched;
            completion = sched + one;
        } else {
            lq[ring(lq_idx, LQ)] = dealloc;
            lq_idx = wrap_add(lq_idx, 1);
        }
        lq_ready = mx(lq_ready, alloc);
        mem_ready = mx(mem_ready, completion);
    }
    a.lq_idx[t] = lq_idx;

    // execution and the write register
    const int64_t read_ops = mem_ready;
    const int64_t write_ops = read_ops + a.cost_ps[t];
    const int32_t wr = a.wreg[rec];
    if (wr != NO_REG) {
        const size_t e = (size_t)t * NUM_REGISTERS +
                         clamp_i32(wr, 0, NUM_REGISTERS - 1);
        a.reg_ready[e] = write_ops;
        a.reg_unit[e] = smov ? UNIT_LOAD : UNIT_EXEC;
    }

    // stores: the store-queue ring, ordered after the last load
    int64_t* sq = a.sq + (size_t)t * SQ;
    int32_t* sq_addr = a.sq_addr + (size_t)t * SQ;
    int32_t sq_idx = a.sq_idx[t];
    const int64_t last_load = lq[ring((int64_t)lq_idx + LQ - 1, LQ)];
    int64_t sq_ready = write_ops;
    const bool stores[2] = {m0v && m0w, m1v && m1w};
    for (int k = 0; k < 2; ++k) {
        if (!stores[k]) continue;
        const int64_t sched = write_ops;
        const int64_t head = sq[ring(sq_idx, SQ)];
        const int64_t last = sq[ring((int64_t)sq_idx + SQ - 1, SQ)];
        const int64_t alloc = mx(head, sched);
        int64_t dealloc;
        if (a.multi_rfo)
            dealloc = mx(mx(alloc + lats[k] + one, last + one), last_load);
        else
            dealloc = mx(mx(sched, last), last_load) + lats[k] + one;
        sq[ring(sq_idx, SQ)] = dealloc;
        sq_addr[ring(sq_idx, SQ)] = lines[k];
        sq_idx = wrap_add(sq_idx, 1);
        sq_ready = mx(sq_ready, alloc);
    }
    a.sq_idx[t] = sq_idx;

    // the clock and the stall breakdown (iocoom_core_model.cc:222-267)
    const bool wm = !smov && ((m0w && m0v) || (m1w && m1v));
    int64_t new_clock = smov ? lq_ready : read_ops;
    if (wm) new_clock = sq_ready;
    const int64_t l1i = instruction_ready - clock;
    const int64_t inter_ex = ready_exec - instruction_ready;
    const int64_t inter_l1d = reg_ops - ready_exec;
    const int64_t lq_stall = lq_ready - reg_ops;
    const int64_t intra_l1d = smov ? 0 : mem_ready - lq_ready;
    const int64_t intra_ex = wm ? write_ops - read_ops : 0;
    const int64_t sq_stall = wm ? sq_ready - write_ops : 0;
    a.load_queue[t] += lq_stall;
    a.store_queue[t] += sq_stall;
    a.l1icache[t] += l1i;
    a.intra_l1d[t] += intra_l1d;
    a.inter_l1d[t] += inter_l1d;
    a.intra_exec[t] += intra_ex;
    a.inter_exec[t] += inter_ex;
    a.ioc_clock[t] = new_clock;
    a.ioc_mem_stall[t] = l1i + inter_l1d + lq_stall + intra_l1d + sq_stall;
    a.ioc_exec_stall[t] = inter_ex + intra_ex;
}

extern "C" int gt_iocoom_commit(const IocArgs* args, cudaStream_t stream) {
    static_assert(sizeof(IocArgs) == (33 + 6) * 8,
                  "IocArgs: 33 pointers and 6 int64");
    const int T = (int)args->T;
    iocoom_commit_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        *args);
    return (int)cudaGetLastError();
}
