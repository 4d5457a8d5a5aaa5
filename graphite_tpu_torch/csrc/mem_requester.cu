// mem_requester: phase 1 of the memory engine, every requester_unroll
// repeat of the requesters' slot starts, in one launch.
//
// Replaces (XLA unit): graphite_tpu/memory/engine.py:1378-1660
// (`_requester_once`: the instruction-buffer fast path, the L1-I/L1-D and
// L2 row lookups, the L1 fill from the L2, the upgrade's eviction and the
// L2 miss's request, the slot bookkeeping, miss counters, miss types and
// line utilization), :1847-1864 (`_apply_functional`) and :1684-1688 (the
// unroll loop).  Plain version: graphite_tpu_torch/ops/mem_requester.py.
//
// Bound: bytes.  A starting lane reads its three set rows (4 + 4 + 8
// packed words by default, 128 B) and ~100 B of lane state, and writes
// them back; ~250 KB an iteration at T = 1024 if every lane starts
// (~0.08 us at 3.35 TB/s).  The launch and one CTA's dependent round
// trips are the floor.
//
// Design: one CTA, one lane a thread (T <= 1024).  Every write of the
// phase belongs to its lane (its cache rows, its requester and request
// cells, its (home, lane) eviction cell, its counters) except the
// functional store, where lanes storing to one word in one repeat race:
// a stamped atomicMax gives the word to the highest lane (the JAX
// scatter's order on the CPU), a block barrier makes every store of the
// repeat visible before the checking loads read, and a second barrier
// separates the repeats.  A lane's rows live in registers (at most WMAX
// ways a level) from the lookup to the write-back.
#include "mem_common.cuh"

#define MAX_THREADS 1024

// Argument block = graphite_tpu_torch/ops/mem_requester.py `_pack`.
struct ReqArgs {
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
    const int32_t* ways;       // [3, T]
    const int32_t* mc;         // [n_mc]
    int64_t* l1i;
    int64_t* l1d;
    int64_t* l2;
    uint8_t* cloc;
    int64_t* util;             // null unless track_util
    int64_t* mt;               // null unless track_mt
    uint8_t* req_type;
    int32_t* req_home;
    int32_t* req_line;
    int64_t* req_time;
    uint8_t* evict_type;       // [T(home), T(src)]
    int32_t* evict_line;
    int64_t* evict_time;
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
    int64_t* l2_hits;
    int64_t* l2_misses;
    int64_t* l2_cold;
    int64_t* l2_cap;
    int64_t* l2_sha;
    int64_t* util_reads;
    int64_t* util_writes;
    int64_t* util_hist;        // [T, 8]
    int64_t* func_mem;         // [func_words + 1]
    int64_t* func_errors;
    int64_t L;
    MemConsts c;
    NetConsts n;
};

template <int NET>
__global__ void __launch_bounds__(MAX_THREADS)
mem_requester_kernel(const ReqArgs a) {
    extern __shared__ long long net_rows[];
    const MemConsts& c = a.c;
    const int T = (int)c.T;
    const int t = threadIdx.x;
    const bool live = t < T;
    const int u = live ? t : 0;

    const int op = a.op[u], flags = a.flags[u];
    const bool act = live && a.active[u];
    const int64_t pc = a.pc[u];
    const int32_t aux0 = a.aux0[u], aux1 = a.aux1[u];
    const int64_t clock = a.clock[u];
    const int64_t f = a.freq[u];
    const bool en = *a.enabled;
    const int col = min(a.idx[u], (int)a.L - 1);
    const int64_t addr0 = a.addr0[(size_t)u * a.L + col];
    const int64_t addr1 = a.addr1[(size_t)u * a.L + col];
    const int64_t* cyc = a.cyc;

    for (int rep = 0; rep < (int)c.unroll; ++rep) {
        const int s = next_slot(c, op, flags, en, a.slot[u]);
        const bool starting = act && a.phase[u] == PHASE_IDLE && s < 3;
        bool progressed = false, func_wr = false, func_chk = false;
        // this repeat's messages: the upgrade's eviction, then the request
        bool up_go = false, miss_go = false, up_dirty = false, wr = false;
        int32_t line = 0;
        int64_t home = 0, req_send = 0, word = 0;
        if (starting) {
            const bool icache = s == 0;
            const int64_t s_addr = icache ? (pc & U32) : (s == 1 ? addr0
                                                                 : addr1);
            line = (int32_t)(s_addr >> c.line_bits);
            const bool s_write =
                !icache && (flags & (s == 1 ? FLAG_MEM0_WRITE
                                            : FLAG_MEM1_WRITE)) != 0;
            const bool ibuf_hit = icache && line == a.instr_buf[u];
            if (icache) a.instr_buf[u] = line;

            Row ri, rd, r2;
            row_load(ri, a.l1i, t, c.S1I, (int)c.W1I, line % a.sets[t]);
            row_load(rd, a.l1d, t, c.S1D, (int)c.W1D, line % a.sets[T + t]);
            row_load(r2, a.l2, t, c.S2, (int)c.W2,
                     line % a.sets[2 * T + t]);
            bool in_e = false, in_i = false, in_f = false;
            if (c.track_mt) {
                in_e = mt_test(a.mt, t, MT_EVICTED, line);
                in_i = mt_test(a.mt, t, MT_INVALIDATED, line);
                in_f = mt_test(a.mt, t, MT_FETCHED, line);
            }
            int wi, sti, wd, std_, w2, st2;
            row_lookup(ri, line, wi, sti);
            row_lookup(rd, line, wd, std_);
            row_lookup(r2, line, w2, st2);
            const int l1_st = icache ? sti : std_;
            const bool l1_permit = s_write ? st_writable(l1_st)
                                           : st_readable(l1_st);
            const bool do_l1 = !ibuf_hit;
            const bool l1_hit = do_l1 && l1_permit;
            const bool l1_miss = do_l1 && !l1_permit;
            const int64_t sync_core = ccyc(
                cyc, t, icache ? CYC_SYNC_CORE_L1I : CYC_SYNC_CORE_L1D, f, en);
            const int64_t l1_dat = ccyc(
                cyc, t, icache ? CYC_L1I_DAT : CYC_L1D_DAT, f, en);
            const int64_t l1_tag = ccyc(
                cyc, t, icache ? CYC_L1I_TAG : CYC_L1D_TAG, f, en);
            const int64_t sync_l1_l2 = ccyc(
                cyc, t, icache ? CYC_SYNC_L1I_L2 : CYC_SYNC_L1D_L2, f, en);

            const bool l2_permit = s_write ? st_writable(st2)
                                           : st_readable(st2);
            const bool l2_hit = l1_miss && l2_permit;
            const bool l2_miss = l1_miss && !l2_permit;
            const bool upgrade = l2_miss && s_write &&
                                 (st2 == ST_SHARED || st2 == ST_OWNED);
            up_dirty = upgrade && st2 == ST_OWNED;
            wr = s_write;
            home = a.mc[line % c.n_mc];
            const size_t ecell = (size_t)home * T + t;
            const bool stall = upgrade && a.evict_type[ecell] != MSG_NONE;
            miss_go = l2_miss && !stall;

            const int64_t sclock = clock + sync_core;
            if (!c.l1i_rr) row_touch(ri, wi, l1_hit && icache);
            if (!c.l1d_rr) row_touch(rd, wd, l1_hit && !icache);
            // the L1 line is invalidated on a miss before the L2 fill
            row_invalidate(ri, line, l1_miss && icache);
            row_invalidate(rd, line, l1_miss && !icache);
            const int64_t l2_hit_done = sclock + l1_tag + sync_l1_l2 +
                                        ccyc(cyc, t, CYC_L2_DAT, f, en) +
                                        l1_dat;
            bool vv;
            int32_t vline;
            int vst;
            Row& r1 = icache ? ri : rd;
            const int vway = row_victim(r1, icache ? c.l1i_rr : c.l1d_rr,
                                        a.ways[(icache ? 0 : T) + t], vv,
                                        vline, vst);
            row_insert(r1, line, vway, st2, l2_hit);
            // an L1 victim's cached-location in the L2 (as stored before
            // this repeat) is cleared, then the fill's is set
            if (vv && l2_hit) {
                const int64_t es = set_of(vline, a.sets[2 * T + t]);
                const int64_t* em = a.l2 + ((size_t)t * c.S2 + es) * c.W2;
                for (int w = 0; w < (int)c.W2; ++w) {
                    const int64_t m = em[w];
                    if (m_tag(m) == vline && m_st(m) != ST_INVALID) {
                        a.cloc[((size_t)t * c.S2 + es) * c.W2 + w] = 0;
                        break;
                    }
                }
            }
            if (l2_hit)
                a.cloc[((size_t)t * c.S2 + r2.set) * c.W2 + w2] =
                    icache ? MOD_L1I : MOD_L1D;
            if (!c.l2_rr) row_touch(r2, w2, l2_hit);

            req_send = sclock + l1_tag + ccyc(cyc, t, CYC_L2_TAG, f, en);
            up_go = upgrade && !stall;
            row_invalidate(r2, line, up_go);
            if (c.track_util) {
                int64_t* uc = a.util + ((size_t)t * c.S2 + r2.set) * c.W2 + w2;
                const int64_t cur = *uc;
                int64_t nu = util_inc(cur, s_write, l2_hit && en);
                if (up_go && en) nu = 0;
                *uc = nu;
                util_classify(a.util_hist, a.util_reads, a.util_writes, t,
                              cur, up_go && en);
            }
            row_store(ri);
            row_store(rd);
            row_store(r2);

            if constexpr (NET == NET_ZL) {
                const int64_t arrival =
                    req_send + net_lat_ps(c, t, home, c.req_bits, en);
                if (up_go) {
                    a.evict_type[ecell] = up_dirty ? MSG_FLUSH_REP
                                                   : MSG_INV_REP;
                    a.evict_line[ecell] = line;
                    a.evict_time[ecell] = arrival;
                }
                if (miss_go) {
                    a.req_type[t] = s_write ? MSG_EX_REQ : MSG_SH_REQ;
                    a.req_home[t] = (int32_t)home;
                    a.req_line[t] = line;
                    a.req_time[t] = arrival;
                }
            }
            if (miss_go) {
                a.phase[t] = PHASE_WAIT_REPLY;
                a.rline[t] = line;
                a.is_write[t] = s_write;
                a.component[t] = icache ? MOD_L1I : MOD_L1D;
                a.rclock[t] = req_send;
            }
            const bool done = ibuf_hit || l1_hit || l2_hit;
            const int64_t done_ps = ibuf_hit ? clock + (en ? cyc_ps(1, f) : 0)
                                    : (l1_hit ? sclock + l1_dat
                                              : l2_hit_done);
            if (done) {
                a.acc[t] += done_ps - clock;
                a.slot_lat[(size_t)t * 3 + s] = done_ps - clock;
            }
            a.slot[t] = done ? s + 1 : s;

            const bool l1_go = l1_miss && !stall;
            if (c.track_mt) {
                const bool cls = miss_go && en;
                a.l2_cap[t] += cls && in_e;
                a.l2_sha[t] += cls && !in_e && (in_i || in_f);
                a.l2_cold[t] += cls && !in_e && !in_i && !in_f;
                mt_set(a.mt, t, MT_INVALIDATED, line, true, up_go);
            }
            if (en) {
                if (icache) {
                    a.l1i_hits[t] += l1_hit || ibuf_hit;
                    a.l1i_misses[t] += l1_go;
                } else if (s_write) {
                    a.l1d_write_hits[t] += l1_hit;
                    a.l1d_write_misses[t] += l1_go;
                } else {
                    a.l1d_read_hits[t] += l1_hit;
                    a.l1d_read_misses[t] += l1_go;
                }
                a.l2_hits[t] += l2_hit;
                a.l2_misses[t] += miss_go;
            }
            progressed = done || miss_go;
            // the functional store of a completed load or store slot
            if (done && !icache && c.func_words > 0) {
                word = (s_addr >> 2) % c.func_words;
                func_wr = s_write;
                func_chk = !s_write && s == 1 && (flags & FLAG_CHECK) != 0;
                if (func_wr)
                    func_write(a.func_mem, word, t,
                               (int64_t)(uint32_t)(s == 1 ? aux0 : aux1));
            }
        }
        if constexpr (NET != NET_ZL) {
            // the two message sets through the contention net, in order:
            // the requests read the queues the evictions committed
            const int64_t up_arr = mem_send<NET>(c, a.n, net_rows, live, t,
                                                 (int)home, c.req_bits,
                                                 req_send, up_go, en);
            const int64_t rq_arr = mem_send<NET>(c, a.n, net_rows, live, t,
                                                 (int)home, c.req_bits,
                                                 req_send, miss_go, en);
            if (up_go) {
                const size_t ecell = (size_t)home * T + t;
                a.evict_type[ecell] = up_dirty ? MSG_FLUSH_REP : MSG_INV_REP;
                a.evict_line[ecell] = line;
                a.evict_time[ecell] = up_arr;
            }
            if (miss_go) {
                a.req_type[t] = wr ? MSG_EX_REQ : MSG_SH_REQ;
                a.req_home[t] = (int32_t)home;
                a.req_line[t] = line;
                a.req_time[t] = rq_arr;
            }
        }
        // every store of this repeat has landed past this barrier
        const int n = __syncthreads_count(progressed);
        if (t == 0 && n > 0) atomicAdd(a.progress, n);
        if (func_chk && func_read(a.func_mem, word) != ((int64_t)aux0 & U32))
            atomicAdd((unsigned long long*)a.func_errors, 1ULL);
        if (func_wr) a.func_mem[word] = func_read(a.func_mem, word);
        __syncthreads();
    }
}

template <int NET>
static int launch(const ReqArgs* args, cudaStream_t stream) {
    const int T = (int)args->c.T;
    const int threads = (T + 31) / 32 * 32;
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            mem_requester_kernel<NET>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    mem_requester_kernel<NET><<<1, threads, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int gt_mem_requester(const ReqArgs* args, cudaStream_t stream) {
    static_assert(sizeof(ReqArgs) == (55 + 1 + 35 + 22) * 8,
                  "ReqArgs: 55 pointers, L, MemConsts and NetConsts");
    switch ((int)args->c.net_kind) {
        case 2: return launch<NET_HBH>(args, stream);
        case 3: return launch<NET_ATAC>(args, stream);
        default: return launch<NET_ZL>(args, stream);
    }
}
