// shl2_requester: phase 1 of the shared-L2 engine, the requesters' slot
// starts (the app thread's L1-only path).
//
// Replaces (XLA unit): graphite_tpu/memory/engine_shl2.py:407-521
// (`_phase_requester`: the instruction-buffer fast path, the L1-I / L1-D
// row lookup, MESI's silent EXCLUSIVE -> MODIFIED promote of a write hit,
// the LRU touch, on an L1 miss the SH / EX request to the line's home
// slice through the MEMORY net, the slot bookkeeping and the L1
// counters) and :642-656 (`_apply_functional`).  Plain version:
// graphite_tpu_torch/ops/shl2_requester.py.
//
// Bound: bytes.  A starting lane reads and writes its two L1 set rows
// (4 + 4 packed words by default, 64 B) and ~90 B of lane state and
// record: ~160 KB an iteration at T = 1024 if every lane starts (~0.05
// us at 3.35 TB/s).  The launch and one CTA's dependent loads are the
// floor.
//
// Design: mem_requester's, without its L2 half: one CTA, one lane a
// thread (T <= 1024); every write is the lane's own (its L1 rows, its
// requester and request cells, its counters) but the functional store,
// which takes the stamped highest-lane-wins write and a block barrier
// before the checking loads.  Under a contention MEMORY net every thread
// routes its request (or nothing) through net_route.cuh after its
// lookups.
#include "shl2_common.cuh"

#define MAX_THREADS 1024

// Argument block = graphite_tpu_torch/ops/shl2_requester.py `_pack`.
struct Shl2ReqArgs {
    const int32_t* op;
    const int32_t* flags;
    const int64_t* pc;
    const int32_t* aux0;
    const int32_t* aux1;
    const bool* active;
    const int64_t* addr0;      // [T, L]
    const int64_t* addr1;
    const int32_t* idx;
    const int64_t* clock;
    const int32_t* freq;
    const bool* enabled;
    int32_t* progress;
    const int64_t* cyc;        // [T, N_CYC]
    const int32_t* sets;       // [3, T]
    int64_t* l1i;
    int64_t* l1d;
    uint8_t* req_type;
    int32_t* req_home;
    int32_t* req_line;
    int64_t* req_time;
    int32_t* phase;
    int32_t* slot;
    int64_t* acc;
    int64_t* rclock;
    int32_t* rline;
    bool* is_write;
    uint8_t* component;
    int32_t* instr_buf;
    int64_t* slot_lat;         // [T, 3]
    int64_t* l1i_hits;
    int64_t* l1i_misses;
    int64_t* l1d_read_hits;
    int64_t* l1d_read_misses;
    int64_t* l1d_write_hits;
    int64_t* l1d_write_misses;
    int64_t* func_mem;         // [func_words + 1]
    int64_t* func_errors;
    int64_t L;
    Shl2Consts s;
    MemConsts c;
    NetConsts n;
};

template <int NET>
__global__ void __launch_bounds__(MAX_THREADS)
shl2_requester_kernel(const Shl2ReqArgs a) {
    extern __shared__ long long net_rows[];
    const MemConsts& c = a.c;
    const int T = (int)c.T;
    const int t = threadIdx.x;
    const bool live = t < T;
    const int u = live ? t : 0;

    const int op = a.op[u], flags = a.flags[u];
    const bool act = live && a.active[u];
    const bool en = *a.enabled;
    const int s = next_slot(c, op, flags, en, a.slot[u]);
    const bool starting = act && a.phase[u] == PHASE_IDLE && s < 3;
    bool progressed = false, func_wr = false, func_chk = false;
    bool miss = false, wr = false;
    int32_t line = 0;
    int64_t home = 0, req_send = 0, word = 0;
    const int32_t aux0 = a.aux0[u], aux1 = a.aux1[u];
    if (starting) {
        const int64_t clock = a.clock[t];
        const int64_t f = a.freq[t];
        const int64_t* cyc = a.cyc;
        const int col = min(a.idx[t], (int)a.L - 1);
        const bool icache = s == 0;
        const int64_t s_addr =
            icache ? (a.pc[t] & U32)
                   : (s == 1 ? a.addr0[(size_t)t * a.L + col]
                             : a.addr1[(size_t)t * a.L + col]);
        line = (int32_t)(s_addr >> c.line_bits);
        wr = !icache &&
             (flags & (s == 1 ? FLAG_MEM0_WRITE : FLAG_MEM1_WRITE)) != 0;
        const bool ibuf_hit = icache && line == a.instr_buf[t];
        if (icache) a.instr_buf[t] = line;

        Row ri, rd;
        row_load(ri, a.l1i, t, c.S1I, (int)c.W1I, line % a.sets[t]);
        row_load(rd, a.l1d, t, c.S1D, (int)c.W1D, line % a.sets[T + t]);
        int wi, sti, wd, std_;
        row_lookup(ri, line, wi, sti);
        row_lookup(rd, line, wd, std_);
        const int l1_st = icache ? sti : std_;
        const bool permit = wr ? st_writable(l1_st) : st_readable(l1_st);
        const bool l1_hit = !ibuf_hit && permit;
        miss = !ibuf_hit && !permit;
        const int64_t l1_dat = ccyc(cyc, t, icache ? CYC_L1I_DAT
                                                   : CYC_L1D_DAT, f, en);
        const int64_t l1_tag = ccyc(cyc, t, icache ? CYC_L1I_TAG
                                                   : CYC_L1D_TAG, f, en);
        // the core -> L1 sync is the L1-D's for both slot kinds
        const int64_t sclock = clock + ccyc(cyc, t, CYC_SYNC_CORE_L1D, f, en);

        // MESI: a write hit on EXCLUSIVE turns MODIFIED with no message
        row_set_state(rd, wd, ST_MODIFIED,
                      l1_hit && wr && l1_st == ST_EXCLUSIVE && !icache);
        if (!c.l1i_rr) row_touch(ri, wi, l1_hit && icache);
        if (!c.l1d_rr) row_touch(rd, wd, l1_hit && !icache);
        row_store(ri);
        row_store(rd);

        home = line % T;
        req_send = sclock + l1_tag + (en ? cyc_ps(a.s.sync_l1_net, f) : 0);
        if constexpr (NET == NET_ZL) {
            if (miss) {
                a.req_type[t] = wr ? MSG_EX_REQ : MSG_SH_REQ;
                a.req_home[t] = (int32_t)home;
                a.req_line[t] = line;
                a.req_time[t] = req_send + net_lat_ps(c, t, home,
                                                      c.req_bits, en);
            }
        }
        if (miss) {
            a.phase[t] = PHASE_WAIT_REPLY;
            a.rline[t] = line;
            a.is_write[t] = wr;
            a.component[t] = icache ? MOD_L1I : MOD_L1D;
            a.rclock[t] = req_send;
        }
        const bool done = ibuf_hit || l1_hit;
        if (done) {
            const int64_t lat = (ibuf_hit ? clock + (en ? cyc_ps(1, f) : 0)
                                          : sclock + l1_dat) - clock;
            a.acc[t] += lat;
            a.slot_lat[(size_t)t * 3 + s] = lat;
        }
        a.slot[t] = done ? s + 1 : s;
        if (en) {
            if (icache) {
                a.l1i_hits[t] += done;
                a.l1i_misses[t] += miss;
            } else if (wr) {
                a.l1d_write_hits[t] += l1_hit;
                a.l1d_write_misses[t] += miss;
            } else {
                a.l1d_read_hits[t] += l1_hit;
                a.l1d_read_misses[t] += miss;
            }
        }
        progressed = done || miss;
        // the functional store of a completed load or store slot
        if (done && !icache && c.func_words > 0) {
            word = (s_addr >> 2) % c.func_words;
            func_wr = wr;
            func_chk = !wr && s == 1 && (flags & FLAG_CHECK) != 0;
            if (func_wr)
                func_write(a.func_mem, word, t,
                           (int64_t)(uint32_t)(s == 1 ? aux0 : aux1));
        }
    }
    if constexpr (NET != NET_ZL) {
        // the requests through the contention net
        const int64_t arrival = mem_send<NET>(c, a.n, net_rows, live, t,
                                              (int)home, c.req_bits,
                                              req_send, miss, en);
        if (miss) {
            a.req_type[t] = wr ? MSG_EX_REQ : MSG_SH_REQ;
            a.req_home[t] = (int32_t)home;
            a.req_line[t] = line;
            a.req_time[t] = arrival;
        }
    }
    // every store of the phase has landed past this barrier
    const int n = __syncthreads_count(progressed);
    if (t == 0 && n > 0) atomicAdd(a.progress, n);
    if (func_chk && func_read(a.func_mem, word) != ((int64_t)aux0 & U32))
        atomicAdd((unsigned long long*)a.func_errors, 1ULL);
    if (func_wr) a.func_mem[word] = func_read(a.func_mem, word);
}

template <int NET>
static int launch(const Shl2ReqArgs* args, cudaStream_t stream) {
    const int T = (int)args->c.T;
    const int threads = (T + 31) / 32 * 32;
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            shl2_requester_kernel<NET>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    shl2_requester_kernel<NET><<<1, threads, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int gt_shl2_requester(const Shl2ReqArgs* args,
                                 cudaStream_t stream) {
    static_assert(sizeof(Shl2ReqArgs) == (38 + 3 + 35 + 22) * 8,
                  "Shl2ReqArgs: 38 pointers, L, Shl2Consts, MemConsts and "
                  "NetConsts");
    if (args->c.T > MAX_THREADS) return (int)cudaErrorInvalidValue;
    switch ((int)args->c.net_kind) {
        case 2: return launch<NET_HBH>(args, stream);
        case 3: return launch<NET_ATAC>(args, stream);
        default: return launch<NET_ZL>(args, stream);
    }
}
