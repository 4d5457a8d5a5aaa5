// mem_requester_fill: phase 6 of the memory engine, the requesters
// consuming their replies, and the engine's completion signal.
//
// Replaces (XLA unit): graphite_tpu/memory/engine.py:2547-2712
// (`_requester_fill`: the L2 victim and its eviction message, the L2 and
// L1 inserts, the cached-location of an L1 victim, the miss-type sets,
// the line utilization, the slot completion and the functional store)
// and :1823-1825 (mem_complete).  Plain version:
// graphite_tpu_torch/ops/mem_requester_fill.py.
//
// Bound: bytes.  A filling lane reads and writes its L2 and L1 set rows
// (96 B by default) and ~80 B of lane state; every lane reads ~20 B for
// the completion signal: ~200 KB an iteration at T = 1024 if every lane
// fills.
//
// Design: as mem_requester — one CTA, one lane a thread (T <= 1024),
// every write the lane's own (its rows, its (victim's home, lane)
// eviction cell, its reply cell, its counters) except the functional
// store, which takes the stamped highest-lane-wins write and one block
// barrier before the checking loads.
#include "mem_common.cuh"

#define MAX_THREADS 1024

// Argument block = graphite_tpu_torch/ops/mem_requester_fill.py `_pack`.
struct FillArgs {
    const int32_t* op;
    const int32_t* flags;
    const int32_t* aux0;
    const int32_t* aux1;
    const int64_t* addr0;      // [T, L]
    const int64_t* addr1;
    const int32_t* idx;
    const int64_t* clock;
    const int32_t* freq;
    const bool* enabled;
    int32_t* progress;
    bool* mem_ok;
    const int64_t* cyc;
    const int32_t* sets;
    const int32_t* ways;
    const int32_t* mc;
    int64_t* l1i;
    int64_t* l1d;
    int64_t* l2;
    uint8_t* cloc;
    int64_t* util;
    int64_t* mt;
    uint8_t* evict_type;
    int32_t* evict_line;
    int64_t* evict_time;
    uint8_t* rep_type;
    int64_t* rep_time;
    int32_t* phase;
    int32_t* slot;
    int64_t* acc;
    const int32_t* rline;
    const bool* is_write;
    const uint8_t* component;
    int64_t* slot_lat;
    int64_t* evictions;
    int64_t* util_reads;
    int64_t* util_writes;
    int64_t* util_hist;
    int64_t* func_mem;
    int64_t* func_errors;
    int64_t L;
    MemConsts c;
    NetConsts n;
};

template <int NET>
__global__ void __launch_bounds__(MAX_THREADS)
mem_requester_fill_kernel(const FillArgs a) {
    extern __shared__ long long net_rows[];
    const MemConsts& c = a.c;
    const int T = (int)c.T;
    const int t = threadIdx.x;
    const bool live = t < T;
    const int u = live ? t : 0;
    const bool en = *a.enabled;
    const int op = a.op[u], flags = a.flags[u];
    const int32_t aux0 = a.aux0[u], aux1 = a.aux1[u];
    const bool have_rep = live && a.phase[u] == PHASE_WAIT_REPLY &&
                          a.rep_type[u] != MSG_NONE;
    bool fill = false, func_wr = false, func_chk = false;
    // the victim's eviction message
    bool evict_go = false, dirty = false;
    int64_t word = 0, v_home = 0, fill_l2 = 0;
    if (have_rep) {
        const int64_t f = a.freq[t];
        const int64_t* cyc = a.cyc;
        const int32_t line = a.rline[t];
        const bool comp_l1i = a.component[t] == MOD_L1I;
        Row r2;
        row_load(r2, a.l2, t, c.S2, (int)c.W2, line % a.sets[2 * T + t]);
        bool e_bit = false, i_bit = false;
        if (c.track_mt) {
            e_bit = mt_test(a.mt, t, MT_EVICTED, line);
            i_bit = mt_test(a.mt, t, MT_INVALIDATED, line);
        }
        bool v_valid;
        int32_t v_line;
        int v_state;
        const int way = row_victim(r2, c.l2_rr, a.ways[2 * T + t], v_valid,
                                   v_line, v_state);
        v_home = a.mc[set_of(v_line, c.n_mc)];
        const size_t ecell = (size_t)v_home * T + t;
        fill = !(v_valid && a.evict_type[ecell] != MSG_NONE);
        evict_go = v_valid && fill;
        if (fill) {
            const int new_state = a.rep_type[t] == MSG_EX_REP ? ST_MODIFIED
                                                              : ST_SHARED;
            row_insert(r2, line, way, new_state, true);
            row_store(r2);
            const size_t lcell = ((size_t)t * c.S2 + r2.set) * c.W2 + way;
            if (c.track_util) {
                const int64_t cur = a.util[lcell];
                if (en) a.util[lcell] = a.is_write[t] ? (1LL << 16) : 1;
                util_classify(a.util_hist, a.util_reads, a.util_writes, t,
                              cur, evict_go && en);
            }
            a.cloc[lcell] = comp_l1i ? MOD_L1I : MOD_L1D;
            dirty = v_state == ST_MODIFIED || v_state == ST_OWNED;
            fill_l2 = a.rep_time[t] + ccyc(cyc, t, CYC_SYNC_L2_NET, f, en) +
                      ccyc(cyc, t, CYC_L2_DAT, f, en);
            const int64_t done = fill_l2 + ccyc(
                cyc, t, comp_l1i ? CYC_L1I_DAT : CYC_L1D_DAT, f, en);
            if (evict_go) {
                a.evict_type[ecell] = dirty ? MSG_FLUSH_REP : MSG_INV_REP;
                a.evict_line[ecell] = v_line;
                if constexpr (NET == NET_ZL)
                    a.evict_time[ecell] = fill_l2 + net_lat_ps(
                        c, t, v_home, dirty ? c.rep_bits : c.req_bits, en);
                if (en) a.evictions[t] += 1;
            }
            a.rep_type[t] = MSG_NONE;
            a.rep_time[t] = 0;

            // the L1 fill; its victim's cached-location in the updated L2
            Row r1;
            if (comp_l1i)
                row_load(r1, a.l1i, t, c.S1I, (int)c.W1I, line % a.sets[t]);
            else
                row_load(r1, a.l1d, t, c.S1D, (int)c.W1D,
                         line % a.sets[T + t]);
            bool vv;
            int32_t vline;
            int vst;
            const int l1way = row_victim(r1, comp_l1i ? c.l1i_rr : c.l1d_rr,
                                         a.ways[(comp_l1i ? 0 : T) + t], vv,
                                         vline, vst);
            row_insert(r1, line, l1way, new_state, true);
            row_store(r1);
            if (vv) {
                const int64_t es = set_of(vline, a.sets[2 * T + t]);
                const size_t rowc = ((size_t)t * c.S2 + es) * c.W2;
                for (int w = 0; w < (int)c.W2; ++w) {
                    const int64_t m = a.l2[rowc + w];
                    if (m_tag(m) == vline && m_st(m) != ST_INVALID) {
                        a.cloc[rowc + w] = 0;
                        break;
                    }
                }
            }
            if (c.track_mt) {
                mt_set(a.mt, t, MT_EVICTED, v_line, true, evict_go);
                const bool same = ((v_line & U32) & (MT_BITS - 1)) ==
                                  ((line & U32) & (MT_BITS - 1));
                const bool e_in = e_bit || (evict_go && same);
                mt_set(a.mt, t, MT_EVICTED, line, false, e_in);
                mt_set(a.mt, t, MT_INVALIDATED, line, false, !e_in && i_bit);
                mt_set(a.mt, t, MT_FETCHED, line, true, true);
            }
            const int s = a.slot[t];
            a.phase[t] = PHASE_IDLE;
            a.slot[t] = s + 1;
            const int64_t lat = done - a.clock[t];
            a.acc[t] += lat;
            if (s >= 0 && s < 3) a.slot_lat[(size_t)t * 3 + s] = lat;
            if (c.func_words > 0) {
                const int col = min(a.idx[t], (int)a.L - 1);
                const int64_t s_addr = s == 1 ? a.addr0[(size_t)t * a.L + col]
                                              : a.addr1[(size_t)t * a.L + col];
                word = (s_addr >> 2) % c.func_words;
                func_wr = a.is_write[t];
                func_chk = !func_wr && s == 1 && (flags & FLAG_CHECK) != 0;
                if (func_wr)
                    func_write(a.func_mem, word, t,
                               (int64_t)(uint32_t)(s == 1 ? aux0 : aux1));
            }
        }
    }
    if constexpr (NET != NET_ZL) {
        // the evictions through the contention net
        const int64_t e_arr = mem_send<NET>(
            c, a.n, net_rows, live, t, (int)v_home,
            dirty ? c.rep_bits : c.req_bits, fill_l2, evict_go, en);
        if (evict_go) a.evict_time[(size_t)v_home * T + t] = e_arr;
    }
    // every store of the phase has landed past this barrier
    const int n = __syncthreads_count(fill);
    if (t == 0 && n > 0) atomicAdd(a.progress, n);
    if (func_chk && func_read(a.func_mem, word) != ((int64_t)aux0 & U32))
        atomicAdd((unsigned long long*)a.func_errors, 1ULL);
    if (func_wr) a.func_mem[word] = func_read(a.func_mem, word);
    if (live)
        a.mem_ok[t] = a.phase[t] == PHASE_IDLE &&
                      next_slot(c, op, flags, en, a.slot[t]) >= 3;
}

template <int NET>
static int launch(const FillArgs* args, cudaStream_t stream) {
    const int T = (int)args->c.T;
    const int threads = (T + 31) / 32 * 32;
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            mem_requester_fill_kernel<NET>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    mem_requester_fill_kernel<NET><<<1, threads, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int gt_mem_requester_fill(const FillArgs* args,
                                     cudaStream_t stream) {
    static_assert(sizeof(FillArgs) == (40 + 1 + 35 + 22) * 8,
                  "FillArgs: 40 pointers, L, MemConsts and NetConsts");
    switch ((int)args->c.net_kind) {
        case 2: return launch<NET_HBH>(args, stream);
        case 3: return launch<NET_ATAC>(args, stream);
        default: return launch<NET_ZL>(args, stream);
    }
}
