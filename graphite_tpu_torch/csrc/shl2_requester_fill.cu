// shl2_requester_fill: phase 6 of the shared-L2 engine, the requesters
// consuming their replies, and the engine's completion signal.
//
// Replaces (XLA unit): graphite_tpu/memory/engine_shl2.py:1141-1230
// (`_requester_fill`: the L1 fill in S, M or MESI's E, the victim pick
// and its EVICT / FLUSH to the victim's home slice, or the wait while
// that home's cell is busy, the slot completion and the functional
// store) with :622-623 (mem_complete).  Plain version:
// graphite_tpu_torch/ops/shl2_requester_fill.py.
//
// Bound: bytes.  A filling lane reads and writes one L1 set row (4
// packed words by default, 32 B), one eviction cell (13 B) and ~70 B of
// lane state; every lane reads ~20 B for the completion signal: ~120 KB
// an iteration at T = 1024 if every lane fills.
//
// Design: mem_requester_fill's, without its L2 half: one CTA, one lane a
// thread (T <= 1024).  Every write is the lane's own: its L1 row, its
// reply cell, its eviction cell (victim's home, lane) — a column only
// this lane writes, so `evict_busy` reads the cell as it stood before
// the phase whatever the other lanes do — and its counters; the
// functional store takes the stamped highest-lane-wins write and one
// block barrier before the checking loads.
#include "shl2_common.cuh"

#define MAX_THREADS 1024

// Argument block = graphite_tpu_torch/ops/shl2_requester_fill.py `_pack`.
struct Shl2FillArgs {
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
    int64_t* l1i;
    int64_t* l1d;
    uint8_t* evict_type;       // [T(home), T(src)]
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
    int64_t* func_mem;
    int64_t* func_errors;
    int64_t L;
    Shl2Consts s;
    MemConsts c;
    NetConsts n;
};

template <int NET>
__global__ void __launch_bounds__(MAX_THREADS)
shl2_requester_fill_kernel(const Shl2FillArgs a) {
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
    int64_t word = 0, v_home = 0, fill_ps = 0;
    if (have_rep) {
        const int64_t f = a.freq[t];
        const int32_t line = a.rline[t];
        const bool comp_l1i = a.component[t] == MOD_L1I;
        const int rt = a.rep_type[t];
        const int new_state = rt == MSG_EX_REP ? ST_MODIFIED
                              : (rt == MSG_EXCL_REP ? ST_EXCLUSIVE
                                                    : ST_SHARED);
        // an upgrade reply lands in the line's own way, a miss in the
        // victim's
        Row r1;
        if (comp_l1i)
            row_load(r1, a.l1i, t, c.S1I, (int)c.W1I, line % a.sets[t]);
        else
            row_load(r1, a.l1d, t, c.S1D, (int)c.W1D, line % a.sets[T + t]);
        int hway, hst;
        const bool hit = row_lookup(r1, line, hway, hst);
        bool vv;
        int32_t v_line;
        int v_state;
        const int vway = row_victim(r1, comp_l1i ? c.l1i_rr : c.l1d_rr,
                                    a.ways[(comp_l1i ? 0 : T) + t], vv,
                                    v_line, v_state);
        const bool v_valid = vv && !hit;
        v_home = set_of(v_line, T);
        const size_t ecell = (size_t)v_home * T + t;
        fill = !(v_valid && a.evict_type[ecell] != MSG_NONE);
        evict_go = v_valid && fill;
        if (fill) {
            row_insert(r1, line, hit ? hway : vway, new_state, true);
            row_store(r1);
            dirty = v_state == ST_MODIFIED;
            fill_ps = a.rep_time[t] + (en ? cyc_ps(a.s.sync_l1_net, f) : 0) +
                      ccyc(a.cyc, t, CYC_L1D_DAT, f, en);
            if (evict_go) {
                a.evict_type[ecell] = dirty ? MSG_FLUSH_REP : MSG_INV_REP;
                a.evict_line[ecell] = v_line;
                if constexpr (NET == NET_ZL)
                    a.evict_time[ecell] = fill_ps + net_lat_ps(
                        c, t, v_home, dirty ? c.rep_bits : c.req_bits, en);
                if (en) a.evictions[t] += 1;
            }
            a.rep_type[t] = MSG_NONE;
            a.rep_time[t] = 0;
            const int s = a.slot[t];
            a.phase[t] = PHASE_IDLE;
            a.slot[t] = s + 1;
            const int64_t lat = fill_ps - a.clock[t];
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
            dirty ? c.rep_bits : c.req_bits, fill_ps, evict_go, en);
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
static int launch(const Shl2FillArgs* args, cudaStream_t stream) {
    const int T = (int)args->c.T;
    const int threads = (T + 31) / 32 * 32;
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            shl2_requester_fill_kernel<NET>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    shl2_requester_fill_kernel<NET><<<1, threads, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int gt_shl2_requester_fill(const Shl2FillArgs* args,
                                      cudaStream_t stream) {
    static_assert(sizeof(Shl2FillArgs) == (32 + 3 + 35 + 22) * 8,
                  "Shl2FillArgs: 32 pointers, L, Shl2Consts, MemConsts and "
                  "NetConsts");
    if (args->c.T > MAX_THREADS) return (int)cudaErrorInvalidValue;
    switch ((int)args->c.net_kind) {
        case 2: return launch<NET_HBH>(args, stream);
        case 3: return launch<NET_ATAC>(args, stream);
        default: return launch<NET_ZL>(args, stream);
    }
}
