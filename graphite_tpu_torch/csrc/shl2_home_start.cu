// shl2_home_start: phase 5 of the shared-L2 engine, the home slices'
// transaction starts (MSI and MESI, each directory scheme).
//
// Replaces (XLA unit): graphite_tpu/memory/engine_shl2.py:933-1138
// (`_home_starts`: resume a saved request or pop the earliest one, the
// `last_line` serialization, the slice lookup, on a miss the victim's
// NULLIFY (its request saved) or silent drop and the install in
// DATA_INVALID with `dram_ready_ps`, the directory FSM over the L1
// sharers under MSI or MESI, the limited_no_broadcast displacement, the
// limitless trap, the ackwise / limited_broadcast broadcast rows and the
// FWD fan-out) with graphite_tpu/memory/engine.py:195-224
// (`_req_earliest`, `_req_consume`).  Plain version:
// graphite_tpu_torch/ops/shl2_home_start.py.
//
// Bound: bytes.  A starting home reads its slice set (W2 packed words,
// 64 B at 8 ways), the set's W2 directory words and one entry's sharer
// words (SW * 4 B, 128 B at T = 1024) and writes one slice row, at most
// two entries and its FWD cells (13 B each; a broadcast row writes T);
// the election reads the T request cells (13 B each) once.
//
// Design: one CTA, one thread a home (T <= 1024).  The election is the
// JAX segment-min: the threads walk the T requester cells together and
// fold every live request into its home's shared-memory atomicMin of
// time * T + requester (the lowest key wins); after one barrier each home
// reads its winner.  Every write then belongs to its home: its slice row
// and directory rows, its transaction, its FWD column fwd[sharer, home],
// and the popped requester's request cell (a requester addresses one
// home).  An ordinary fan-out is written by the home's thread, one cell a
// set bit of the pending words (__ffs).  A broadcast row (an overflowed
// ackwise / limited_broadcast sweep: every tile but the requester) is
// queued in shared memory and written by the whole CTA after a barrier,
// one target a thread, so no thread walks a 1,024-cell column alone (the
// private engine's `mem_home_start[ext]` does, PERF.md §6).  Under a
// contention MEMORY net (the NET_HBH / NET_ATAC instantiations) every
// thread goes through fanout.cuh's routed fan-out after its start, the
// home's thread writing its copies, a broadcast row's too (their ranks
// and the queue charges are the home's).
#include "fanout.cuh"
#include "shl2_common.cuh"

#define MAX_HOMES 1024
#define FAR (1ULL << 62)

// Argument block = graphite_tpu_torch/ops/shl2_home_start.py `_pack`.
struct Shl2HomeArgs {
    const int32_t* freq;
    const bool* enabled;
    int32_t* progress;
    const int64_t* cyc;        // [T, N_CYC]
    const int32_t* sets;       // [3, T]
    const int32_t* ways;       // [3, T]
    const int64_t* dram_rt;    // [T] DRAM round trip, models on
    int64_t* l2;               // [T, S2, W2]
    int64_t* word;             // [T, S2, W2]
    int32_t* sharers;          // [T, S2, W2 * SW]
    uint8_t* req_type;
    const int32_t* req_home;
    const int32_t* req_line;
    const int64_t* req_time;
    uint8_t* fwd_type;         // [T(sharer), T(home)]
    int32_t* fwd_line;
    int64_t* fwd_time;
    bool* active;
    uint8_t* mtype;
    int32_t* line;
    int32_t* requester;
    uint8_t* req_comp;
    int64_t* time_ps;
    int64_t* dram_ready_ps;
    bool* got_flush;
    bool* saved_valid;
    uint8_t* saved_type;
    int32_t* saved_line;
    int32_t* saved_requester;
    uint8_t* saved_comp;
    int64_t* saved_time_ps;
    int32_t* last_line;
    int64_t* last_done_ps;
    int32_t* pending;          // [T, SW]
    int64_t* dir_accesses;
    int64_t* dir_broadcasts;
    int64_t* l2_hits;
    int64_t* l2_misses;
    int64_t* dram_reads;
    int64_t* dram_writes;
    int64_t* dram_total_lat;
    int64_t unused;
    Shl2Consts s;
    MemConsts c;
    NetConsts n;
};

template <int NET>
__global__ void __launch_bounds__(MAX_HOMES)
shl2_home_start_kernel(const Shl2HomeArgs a) {
    extern __shared__ long long net_rows[];
    const MemConsts& c = a.c;
    const int T = (int)c.T, SW = (int)c.SW, W2 = (int)c.W2;
    const int h = threadIdx.x;
    const bool valid = h < T;
    __shared__ unsigned long long best[MAX_HOMES];
    // the broadcast rows queued for the whole CTA
    __shared__ int n_bc;
    __shared__ int bc_home[MAX_HOMES];
    __shared__ int bc_req[MAX_HOMES];
    __shared__ int32_t bc_line[MAX_HOMES];
    __shared__ int64_t bc_time[MAX_HOMES];
    best[h] = FAR;
    if (h == 0) n_bc = 0;
    __syncthreads();
    for (int r = h; r < T; r += blockDim.x) {
        if (a.req_type[r] == MSG_NONE) continue;
        atomicMin(&best[a.req_home[r]],
                  (unsigned long long)(a.req_time[r] * T + r));
    }
    __syncthreads();
    const bool en = *a.enabled;
    const unsigned long long key = best[h];
    const bool found = key < FAR;
    const int r_col = found ? (int)(key % (unsigned long long)T) : 0;
    const bool can_start = valid && !a.active[h];
    const bool use_saved = can_start && a.saved_valid[h];
    const bool use_pop = can_start && !use_saved && found;
    const bool starting = use_saved || use_pop;
    // this home's fan-out, routed after the starts under a contention net
    bool fan = false, bcast = false;
    int fwd_msg = MSG_INV_REQ, rc = 0;
    int32_t eff_line = 0;
    int64_t eff_time = 0;
    if (starting) {
        const int64_t f = a.freq[h];
        const int rtype = use_saved ? a.saved_type[h] : a.req_type[r_col];
        const int32_t rline = use_saved ? a.saved_line[h] : a.req_line[r_col];
        const int rreq = use_saved ? a.saved_requester[h] : r_col;
        const int rcomp = use_saved ? a.saved_comp[h] : MOD_L1D;
        int64_t rtime = use_saved
            ? a.saved_time_ps[h]
            : a.req_time[r_col] + ccyc(a.cyc, h, CYC_SYNC_L2_NET, f, en);
        // same-line serialization floor
        if (rline == a.last_line[h]) rtime = max(rtime, a.last_done_ps[h]);
        if (use_pop) a.req_type[r_col] = MSG_NONE;
        if (use_saved) a.saved_valid[h] = false;

        // the slice set (the victim and the effective line share it)
        const int64_t set = set_of(rline, a.sets[2 * T + h]);
        Row r2;
        row_load(r2, a.l2, h, c.S2, W2, set);
        int hway, hst;
        const bool l2_hit = row_lookup(r2, rline, hway, hst);
        bool v_valid;
        int32_t v_line;
        int v_state;
        const int v_way = row_victim(r2, c.l2_rr, a.ways[2 * T + h],
                                     v_valid, v_line, v_state);
        int64_t* words = a.word + ((size_t)h * c.S2 + set) * W2;
        int32_t* shrow = a.sharers + ((size_t)h * c.S2 + set) * W2 * SW;
        const int v_dstate = sw_state(words[v_way]);
        const bool nullify = !l2_hit && v_valid && v_dstate != DIR_UNCACHED;
        // a victim with no L1 copies is dropped now (dirty -> DRAM)
        const bool silent_kill = !l2_hit && v_valid &&
                                 v_dstate == DIR_UNCACHED;
        row_invalidate(r2, v_line, silent_kill);
        const bool dram_wb = silent_kill && v_state == ST_MODIFIED;
        if (nullify) {
            a.saved_valid[h] = true;
            a.saved_type[h] = (uint8_t)rtype;
            a.saved_line[h] = rline;
            a.saved_requester[h] = rreq;
            a.saved_comp[h] = (uint8_t)rcomp;
            a.saved_time_ps[h] = rtime;
        }
        // install the new line in DATA_INVALID with an empty entry
        if (!l2_hit && !nullify) {
            row_insert(r2, rline, v_way, DATA_INVALID, true);
            words[v_way] = sw_set(words[v_way], DIR_UNCACHED, -1, 0);
            for (int w = 0; w < SW; ++w) shrow[(size_t)v_way * SW + w] = 0;
        }

        eff_line = nullify ? v_line : rline;
        const int eff_type = nullify ? MSG_NULLIFY : rtype;
        eff_time = rtime + ccyc(a.cyc, h, CYC_L2_DAT, f, en);
        int eway, est;
        row_lookup(r2, eff_line, eway, est);
        int32_t* esh = shrow + (size_t)eway * SW;
        const int64_t eword = words[eway];
        const int dstate = sw_state(eword);
        const int32_t owner = sw_owner(eword), nsh = sw_nsh(eword);
        const bool is_ex = eff_type == MSG_EX_REQ;
        const bool is_sh = eff_type == MSG_SH_REQ;
        const bool data_missing = !nullify && est == DATA_INVALID;
        const bool served = !nullify && !data_missing;
        const bool shared = dstate == DIR_SHARED;
        const bool owned_like = dstate == DIR_MODIFIED ||
                                dstate == DIR_EXCLUSIVE;

        // the fan-out: EX / NULLIFY on SHARED invalidates the sharers,
        // anything on M / E goes to the owner (WB for SH, else FLUSH)
        const bool fan_inv = (served && is_ex && shared) ||
                             (nullify && shared);
        const bool fan_owner = (served || nullify) && owned_like;
        fan = fan_inv || fan_owner;
        fwd_msg = fan_inv ? MSG_INV_REQ
                          : (is_sh ? MSG_WB_REQ : MSG_FLUSH_REQ);
        const int ow = min(max((int)owner, 0), T - 1);
        rc = min(max(rreq, 0), T - 1);
        int32_t* pend = a.pending + (size_t)h * SW;
        const bool up_clear = served && is_ex && shared;
        const int64_t k = c.max_hw_sharers;
        const bool already = bit_test(esh, rreq);
        // limited_no_broadcast at capacity: an SH on SHARED displaces the
        // lowest sharer; on M / E the owner is flushed and the entry
        // empties
        const bool lnb = c.scheme == SCHEME_LIMITED_NO_BROADCAST;
        const bool sh_over = lnb && served && is_sh && shared && nsh >= k &&
                             !already;
        const bool sh_over_m = lnb && served && is_sh && owned_like &&
                               nsh >= k && !already;
        const int victim = sh_over ? lowest_sharer(esh, SW, -1) : -1;
        for (int w = 0; w < SW; ++w) {
            uint32_t bits = 0;
            if (sh_over) {
                if (victim >= 0 && victim / 32 == w)
                    bits = 1u << (victim % 32);
            } else if (fan_inv) {
                bits = (uint32_t)esh[w];
                if (up_clear && rc / 32 == w) bits &= ~(1u << (rc % 32));
            } else if (fan_owner && ow / 32 == w) {
                bits = 1u << (ow % 32);
            }
            pend[w] = (int32_t)bits;
        }
        if (sh_over) {
            fan = true;
            fwd_msg = MSG_INV_REQ;
            words[eway] = sw_set_nsh(eword, nsh - 1);
            if (victim >= 0)
                esh[victim / 32] = (int32_t)((uint32_t)esh[victim / 32] &
                                             ~(1u << (victim % 32)));
        }
        if (sh_over_m) {
            fwd_msg = MSG_FLUSH_REQ;
            words[eway] = sw_set(eword, DIR_UNCACHED, -1, 0);
            for (int w = 0; w < SW; ++w) esh[w] = 0;
        }
        // limitless: an overflowed entry is served by the software trap
        if (c.scheme == SCHEME_LIMITLESS && en &&
            (nsh > k || (is_sh && !already && nsh >= k &&
                         (shared || owned_like))))
            eff_time += c.trap_ps;
        row_store(r2);

        a.active[h] = true;
        a.mtype[h] = (uint8_t)eff_type;
        a.line[h] = eff_line;
        a.requester[h] = rreq;
        a.req_comp[h] = (uint8_t)rcomp;
        a.time_ps[h] = eff_time;
        a.got_flush[h] = false;
        a.dram_ready_ps[h] = data_missing
            ? eff_time + (en ? a.dram_rt[h] : 0) : (int64_t)FAR;

        // the FWD copies: a broadcast row goes to the CTA below, an
        // ordinary fan-out is written here
        bcast = (c.scheme == SCHEME_ACKWISE ||
                 c.scheme == SCHEME_LIMITED_BROADCAST) && fan_inv && nsh > k;
        if (NET != NET_ZL) {
            // routed below, by every thread
        } else if (bcast) {
            const int i = atomicAdd(&n_bc, 1);
            bc_home[i] = h;
            bc_req[i] = rc;
            bc_line[i] = eff_line;
            bc_time[i] = eff_time;
        } else if (fan) {
            for (int w = 0; w < SW; ++w) {
                for (uint32_t bits = (uint32_t)pend[w]; bits;
                     bits &= bits - 1) {
                    const int s = w * 32 + __ffs(bits) - 1;
                    if (s >= T) break;
                    const size_t cell = (size_t)s * T + h;
                    a.fwd_type[cell] = (uint8_t)fwd_msg;
                    a.fwd_line[cell] = eff_line;
                    a.fwd_time[cell] = eff_time + net_lat_ps(
                        c, h, s, c.req_bits, en);
                }
            }
        }
        if (en) {
            a.dir_accesses[h] += 1;
            a.dir_broadcasts[h] += bcast;
            a.l2_hits[h] += served;
            a.l2_misses[h] += data_missing;
            a.dram_reads[h] += data_missing;
            a.dram_writes[h] += dram_wb;
            if (data_missing) a.dram_total_lat[h] += c.dram_lat_ps;
        }
    }
    const int n = __syncthreads_count(starting);
    if (h == 0 && n > 0) atomicAdd(a.progress, n);
    if constexpr (NET != NET_ZL) {
        // the fan-outs through the contention net: the targets are the
        // pending words, and for a broadcast row every tile but the
        // requester
        const int32_t* pend = a.pending + (size_t)(valid ? h : 0) * SW;
        fan_out_routed<NET>(
            c, a.n, net_rows, valid, h, fan,
            [&](int w) {
                uint32_t b = (uint32_t)pend[w];
                if (bcast) {
                    const int m = T - w * 32;
                    b |= m >= 32 ? 0xFFFFFFFFu : (1u << m) - 1;
                    if (rc / 32 == w && !bit_test(pend, rc))
                        b &= ~(1u << (rc % 32));
                }
                return b;
            },
            [&](int) { return fwd_msg; }, a.fwd_type, a.fwd_line,
            a.fwd_time, eff_line, eff_time, en);
        return;
    }
    // the broadcast rows: every tile but the requester, or a holder of
    // the line (the pending words; an upgrader's own bit is cleared)
    for (int i = 0; i < n_bc; ++i) {
        const int hh = bc_home[i];
        const int32_t* pend = a.pending + (size_t)hh * SW;
        for (int s = h; s < T; s += blockDim.x) {
            if (s == bc_req[i] && !bit_test(pend, s)) continue;
            const size_t cell = (size_t)s * T + hh;
            a.fwd_type[cell] = MSG_INV_REQ;
            a.fwd_line[cell] = bc_line[i];
            a.fwd_time[cell] = bc_time[i] + net_lat_ps(c, hh, s, c.req_bits,
                                                       en);
        }
    }
}

template <int NET>
static int launch(const Shl2HomeArgs* args, cudaStream_t stream) {
    const int T = (int)args->c.T;
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            shl2_home_start_kernel<NET>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    shl2_home_start_kernel<NET><<<1, (T + 31) / 32 * 32, smem, stream>>>(
        *args);
    return (int)cudaGetLastError();
}

extern "C" int gt_shl2_home_start(const Shl2HomeArgs* args,
                                  cudaStream_t stream) {
    static_assert(sizeof(Shl2HomeArgs) == (41 + 3 + 35 + 22) * 8,
                  "Shl2HomeArgs: 41 pointers, one int, Shl2Consts, "
                  "MemConsts and NetConsts");
    if (args->c.T > MAX_HOMES) return (int)cudaErrorInvalidValue;
    switch ((int)args->c.net_kind) {
        case 2: return launch<NET_HBH>(args, stream);
        case 3: return launch<NET_ATAC>(args, stream);
        default: return launch<NET_ZL>(args, stream);
    }
}
