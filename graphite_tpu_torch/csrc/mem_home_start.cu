// mem_home_start: phase 3 of the memory engine, the homes' transaction
// starts (MSI and MOSI, each directory scheme).
//
// Replaces (XLA unit): graphite_tpu/memory/engine.py:2219-2546
// (`_home_starts`: resume a saved request or pop the earliest one,
// directory lookup / allocation with NULLIFY of a full set's
// fewest-sharer victim, the immediate finishes with their DRAM or
// buffered reply, and the INV / FLUSH / WB fan-out into the FWD matrix;
// MOSI's cache-to-cache SH fetch and INV_FLUSH_COMBINED supplier; the
// limited_no_broadcast displacement, the ackwise / limited_broadcast
// sweep to every tile and the limitless trap) with :195-224
// (`_req_earliest`, `_req_consume`).  Plain version:
// graphite_tpu_torch/ops/mem_home_start.py.
//
// Bound: bytes.  A starting home reads its directory set (DW packed
// words, 128 B at DW = 16), one entry's sharer words (SW * 4 B, 128 B at
// T = 1024), writes one entry and at most T FWD cells (13 B each; an
// overflowed broadcast sweep writes all T); every CTA also reads the T
// request cells (13 B each) for the election.
//
// Design: one thread a home, HOMES homes a CTA.  The election is the JAX
// segment-min: each CTA's threads walk the T requester cells together and
// fold every live request addressed to one of the CTA's homes into a
// shared-memory atomicMin of time * T + requester (the lowest key wins,
// the key order of `_req_earliest`); after one barrier each home reads
// its winner.  Every write then belongs to its home: its directory set,
// its transaction, its FWD column fwd[sharer, home], the popped
// requester's request cell and the replied requester's reply cell (a
// requester has one outstanding miss, so one home pops and replies to
// it).  The victim entry's sharer words are read for the reply and the
// fan-out before the entry is rewritten in place (at most one write an
// entry a call: the install / immediate finish and the two
// limited_no_broadcast writes fall on disjoint homes); a fan-out walks
// the set bits of the pending words (or of every tile, for a broadcast
// sweep) with __ffs, one copy's message possibly differing (`ovr_col`:
// the data supplier).  The protocol and the scheme come in the argument
// block (`MemConsts`), so every thread takes the same branch; a template
// flag (EXT: MOSI, or a scheme other than full_map) leaves MSI full_map
// an instantiation without those branches: inline, they cost its zero-
// load form 8 registers, a 16-byte spill and 0.5 µs a call at the
// companion's miss-heavy state (PERF.md §6).  Each flag value has its
// own entry point (`gt_mem_home_start`, `gt_mem_home_start_ext`), so
// their launches count apart.
#include "fanout.cuh"

#define HOMES 128          // homes a CTA, under the zero-load nets
#define MAX_HOMES 1024     // the one CTA of a contention net
#define FAR (1ULL << 62)
#define TAG_MASK ((1LL << 34) - 1)
#define ID_MASK ((1LL << 13) - 1)
#define STATE_SHIFT 34
#define OWNER_SHIFT 37
#define NSH_SHIFT 50

// Argument block = graphite_tpu_torch/ops/mem_home_start.py `_pack`.
struct HomeArgs {
    const bool* enabled;
    int32_t* progress;
    int64_t* entry;            // [T, DS, DW]
    int32_t* sharers;          // [T, DS, DW * SW]
    uint8_t* req_type;
    const int32_t* req_home;
    const int32_t* req_line;
    const int64_t* req_time;
    uint8_t* rep_type;
    int64_t* rep_time;
    uint8_t* fwd_type;         // [T(sharer), T(home)]
    int32_t* fwd_line;
    int64_t* fwd_time;
    bool* active;
    uint8_t* mtype;
    int32_t* line;
    int32_t* requester;
    int64_t* time_ps;
    bool* data_cached;
    bool* saved_valid;
    uint8_t* saved_type;
    int32_t* saved_line;
    int32_t* saved_requester;
    int64_t* saved_time_ps;
    int32_t* last_line;
    int64_t* last_done_ps;
    int32_t* cdata_line;
    bool* cdata_valid;
    int32_t* pending;          // [T, SW]
    int64_t* dir_accesses;
    int64_t* dram_reads;
    int64_t* dram_total_lat;
    int64_t* dir_broadcasts;
    int64_t unused;
    MemConsts c;
    NetConsts n;
};

__device__ __forceinline__ int32_t e_tag(int64_t w) {
    return (int32_t)(w & TAG_MASK) - 1;
}
__device__ __forceinline__ int e_state(int64_t w) {
    return (int)((w >> STATE_SHIFT) & 7);
}
__device__ __forceinline__ int32_t e_owner(int64_t w) {
    return (int32_t)((w >> OWNER_SHIFT) & ID_MASK) - 1;
}
__device__ __forceinline__ int32_t e_nsh(int64_t w) {
    return (int32_t)((w >> NSH_SHIFT) & ID_MASK);
}
__device__ __forceinline__ int64_t e_pack(int64_t tag, int st, int64_t owner,
                                          int64_t nsh) {
    return ((tag + 1) & TAG_MASK) | ((int64_t)(st & 7) << STATE_SHIFT) |
           (((owner + 1) & ID_MASK) << OWNER_SHIFT) |
           ((nsh & ID_MASK) << NSH_SHIFT);
}

// word w of a fan-out's targets: the pending words, or every tile (an
// overflowed broadcast sweep)
__device__ __forceinline__ uint32_t target_word(const int32_t* pend, int w,
                                                bool bcast, int T) {
    if (!bcast) return (uint32_t)pend[w];
    const int n = T - w * 32;               // >= 1 for w < SW
    return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1;
}

// A contention net's fan-out (fanout.cuh `fan_out_routed`): the copies
// go to the set bits of the pending words, or to every tile for a
// broadcast sweep, the data supplier `ovr_col` with its own message.
template <int NET, bool EXT>
__device__ __forceinline__ void fan_out(const HomeArgs& a, long long* rows,
                                        bool valid, int h, bool fan,
                                        bool bcast, int fwd_msg, int ovr_col,
                                        int ovr_msg, int32_t eff_line,
                                        int64_t eff_time, bool en) {
    const int T = (int)a.c.T;
    const int32_t* pend = a.pending + (size_t)(valid ? h : 0) * a.c.SW;
    fan_out_routed<NET>(
        a.c, a.n, rows, valid, h, fan,
        [&](int w) { return target_word(pend, w, bcast, T); },
        [&](int s) { return EXT && s == ovr_col ? ovr_msg : fwd_msg; },
        a.fwd_type, a.fwd_line, a.fwd_time, eff_line, eff_time, en);
}

template <int NET, bool EXT>
__global__ void __launch_bounds__(NET == NET_ZL ? HOMES : MAX_HOMES)
mem_home_start_kernel(const HomeArgs a) {
    constexpr int NB = NET == NET_ZL ? HOMES : MAX_HOMES;
    extern __shared__ long long net_rows[];
    const MemConsts& c = a.c;
    const int T = (int)c.T;
    const int base = blockIdx.x * NB;
    const int h = base + threadIdx.x;
    __shared__ unsigned long long best[NB];
    best[threadIdx.x] = FAR;
    __syncthreads();
    for (int r = threadIdx.x; r < T; r += blockDim.x) {
        if (a.req_type[r] == MSG_NONE) continue;
        const int hh = a.req_home[r] - base;
        if (hh >= 0 && hh < (int)blockDim.x)
            atomicMin(&best[hh], (unsigned long long)(a.req_time[r] * T + r));
    }
    __syncthreads();
    const bool valid = h < T;
    const bool en = *a.enabled;

    // this home's messages: the immediate reply, the fan-out
    bool imm = false, imm_ex = false, fan = false, bcast = false;
    int32_t rreq = 0, eff_line = 0;
    int64_t ready = 0, eff_time = 0;
    int fwd_msg = 0, ovr_col = -1, ovr_msg = MSG_FLUSH_REQ;
    const unsigned long long key = best[threadIdx.x];
    const bool found = key < FAR;
    const int r_col = found ? (int)(key % (unsigned long long)T) : 0;
    const bool can_start = valid && !a.active[h];
    const bool use_saved = can_start && a.saved_valid[h];
    const bool use_pop = can_start && !use_saved && found;
    const bool starting = use_saved || use_pop;
    if constexpr (NET == NET_ZL) {
        if (!starting) return;     // no barrier follows
    }
    if (starting) {
        const int64_t dram_lat = en ? c.dram_lat_ps : 0;
        const int64_t dir_access = en ? c.dir_access_ps : 0;
        const int rtype = use_saved ? a.saved_type[h] : a.req_type[r_col];
        const int32_t rline = use_saved ? a.saved_line[h] : a.req_line[r_col];
        rreq = use_saved ? a.saved_requester[h] : r_col;
        int64_t rtime = use_saved ? a.saved_time_ps[h] : a.req_time[r_col];
        // the directory's message sync, once per message
        if (!use_saved)
            rtime += en ? (rreq == h ? c.sync_dir_l2_ps : c.sync_dir_net_ps)
                        : 0;
        // same-address serialization floor
        if (rline == a.last_line[h]) rtime = max(rtime, a.last_done_ps[h]);
        if (use_pop) a.req_type[r_col] = MSG_NONE;
        if (use_saved) a.saved_valid[h] = false;

        // the directory set: lookup, else a free way, else the fewest
        // sharers
        const int DW = (int)c.DW, SW = (int)c.SW;
        const int64_t set = rline % c.DS;
        int64_t* words = a.entry + ((size_t)h * c.DS + set) * DW;
        int way = -1, free_way = -1, victim = 0;
        int32_t min_nsh = 0x7FFFFFFF;
        for (int w = 0; w < DW; ++w) {
            const int64_t e = words[w];
            const int32_t tag = e_tag(e);
            if (way < 0 && tag == rline) way = w;
            if (free_way < 0 && tag == -1) free_way = w;
            if (e_nsh(e) < min_nsh) { min_nsh = e_nsh(e); victim = w; }
        }
        const bool dfound = way >= 0;
        const int alloc = dfound ? way : (free_way >= 0 ? free_way : victim);
        const int64_t vw = words[alloc];
        const int32_t v_line = e_tag(vw), v_owner = e_owner(vw);
        const int v_dstate = e_state(vw);
        int32_t* vsh = a.sharers + ((size_t)h * c.DS + set) * DW * SW +
                       (size_t)alloc * SW;

        // NULLIFY: a full set's live victim runs first; the request is
        // saved
        const bool nullify = !dfound && free_way < 0 &&
                             v_dstate != DIR_UNCACHED;
        if (nullify) {
            a.saved_valid[h] = true;
            a.saved_type[h] = (uint8_t)rtype;
            a.saved_line[h] = rline;
            a.saved_requester[h] = rreq;
            a.saved_time_ps[h] = rtime;
        }
        eff_line = nullify ? v_line : rline;
        const int eff_type = nullify ? MSG_NULLIFY : rtype;
        const int eff_dstate = nullify ? v_dstate
                                       : (dfound ? v_dstate : DIR_UNCACHED);
        eff_time = rtime + dir_access;
        const bool run_req = !nullify;
        const bool is_ex = eff_type == MSG_EX_REQ;
        const bool is_sh = eff_type == MSG_SH_REQ;
        const bool uncached = eff_dstate == DIR_UNCACHED;
        const bool shared = eff_dstate == DIR_SHARED;
        const bool modified = eff_dstate == DIR_MODIFIED;
        const bool owned = eff_dstate == DIR_OWNED;
        const bool mosi = EXT && c.is_mosi != 0;
        const bool lnb = EXT && c.scheme == SCHEME_LIMITED_NO_BROADCAST;

        // the directory scheme: the hardware list holds k sharers
        const int64_t k = c.max_hw_sharers;
        const int32_t v_nsh = e_nsh(vw);
        bool already = false;
        if constexpr (EXT)
            already = ((uint32_t)vsh[rreq / 32] >> (rreq % 32)) & 1;
        // limited_no_broadcast: a (k+1)-th reader displaces a tracked
        // sharer; a MODIFIED entry at capacity flushes its owner out
        const bool at_cap = lnb && run_req && is_sh && v_nsh >= k && !already;
        const bool sh_over = at_cap && (shared || owned);
        const bool sh_over_m = at_cap && modified;
        // limitless: an overflowed entry is served by the software trap
        if (EXT && c.scheme == SCHEME_LIMITLESS && en && dfound &&
            (v_nsh > k ||
             (is_sh && !already && v_nsh >= k && (shared || owned))))
            eff_time += c.trap_ps;

        // (a) immediate finishes: UNCACHED requests; MSI also serves SH
        // on SHARED from DRAM (MOSI fetches it cache-to-cache, below)
        imm_ex = run_req && is_ex && uncached;
        const bool imm_sh = run_req && is_sh &&
                            (mosi ? uncached
                                  : (uncached || shared) && !sh_over);
        imm = imm_ex || imm_sh;
        const bool keep = imm_sh && shared;   // the entry's sharers stay
        int32_t n_cur = 0;
        bool had = false;
        if (keep) {
            for (int w = 0; w < SW; ++w) n_cur += __popc((uint32_t)vsh[w]);
            had = ((uint32_t)vsh[rreq / 32] >> (rreq % 32)) & 1;
        }

        // (b) fan-out: EX/NULLIFY on SHARED (MOSI: and OWNED) invalidates
        // every sharer; any request on MODIFIED goes to the owner (WB for
        // SH, else FLUSH); MOSI's SH on SHARED/OWNED fetches from one
        // holder (WB); the targets are the pending words, the copies go
        // out below
        const bool fan_inv =
            (mosi ? (run_req && is_ex) || nullify : is_ex || nullify) &&
            (shared || (mosi && owned));
        const bool sh_fetch = mosi && run_req && is_sh && (shared || owned) &&
                              !sh_over;
        fan = fan_inv || modified || sh_fetch || sh_over;
        if (fan) {
            const int owner = min(max(v_owner, 0), T - 1);
            const bool dirty_owner = owned && v_owner >= 0;
            // the cache-to-cache source: the owner of an OWNED entry,
            // else the lowest sharer
            const int src = mosi || lnb
                ? (dirty_owner ? v_owner : lowest_sharer(vsh, SW, -1)) : -1;
            fwd_msg = fan_inv ? MSG_INV_REQ
                              : (is_sh ? MSG_WB_REQ : MSG_FLUSH_REQ);
            // the sweep's data supplier gets INV_FLUSH_COMBINED: the
            // owner of an OWNED entry, else the lowest sharer on an EX
            if (mosi && fan_inv && (owned || (run_req && is_ex && shared)))
                ovr_col = src;
            // limited_no_broadcast's victim: the lowest sharer that is
            // not the dirty owner, else the owner itself
            int vic = -1;
            bool victim_is_owner = false;
            if (sh_over) {
                const int v0 = lowest_sharer(vsh, SW, dirty_owner ? owner
                                                                 : -1);
                victim_is_owner = v0 < 0;
                vic = v0 >= 0 ? v0 : owner;
                fwd_msg = MSG_INV_REQ;
                if (mosi && (shared || victim_is_owner)) {
                    ovr_col = vic;       // leaves and supplies
                } else if (mosi && owned) {
                    ovr_col = owner;     // supplies alongside
                    ovr_msg = MSG_WB_REQ;
                }
            }
            if (sh_over_m) fwd_msg = MSG_FLUSH_REQ;
            // ackwise / limited_broadcast: an overflowed entry's sweep
            // goes to every tile; the acks awaited stay the true holders
            bcast = EXT && fan_inv && v_nsh > k &&
                    (c.scheme == SCHEME_ACKWISE ||
                     c.scheme == SCHEME_LIMITED_BROADCAST);
            if (bcast && en) a.dir_broadcasts[h] += 1;
            int32_t* pend = a.pending + (size_t)h * SW;
            for (int w = 0; w < SW; ++w) {
                uint32_t bits = 0;
                if (sh_over) {
                    // the victim, and an OWNED entry's owner, which
                    // supplies the data
                    if (vic / 32 == w) bits |= 1u << (vic % 32);
                    if (owned && !victim_is_owner && v_owner >= 0 &&
                        owner / 32 == w)
                        bits |= 1u << (owner % 32);
                } else if (fan_inv) {
                    bits = (uint32_t)vsh[w];
                } else if (sh_fetch) {
                    if (src >= 0 && min(src, T - 1) / 32 == w)
                        bits = 1u << (min(src, T - 1) % 32);
                } else if (owner / 32 == w) {
                    bits = 1u << (owner % 32);
                }
                pend[w] = (int32_t)bits;
                if constexpr (NET == NET_ZL) {
                    // the zero-load copies go out here, one a target
                    if (bcast) bits = target_word(pend, w, true, T);
                    while (bits) {
                        const int b = __ffs(bits) - 1;
                        bits &= bits - 1;
                        const int s = w * 32 + b;
                        if (s >= T) break;
                        const size_t cell = (size_t)s * T + h;
                        a.fwd_type[cell] = (uint8_t)(
                            EXT && s == ovr_col ? ovr_msg : fwd_msg);
                        a.fwd_line[cell] = eff_line;
                        a.fwd_time[cell] = eff_time + net_lat_ps(
                            c, h, s, c.req_bits, en);
                    }
                }
            }
            a.active[h] = true;
            a.mtype[h] = (uint8_t)eff_type;
            a.line[h] = eff_line;
            a.requester[h] = rreq;
            a.time_ps[h] = eff_time;
            a.data_cached[h] = false;

            // limited_no_broadcast's in-place entry writes: the victim
            // leaves now (its ack is this transaction's), or the MODIFIED
            // entry at capacity empties (the finish installs the
            // requester alone)
            if (sh_over) {
                words[alloc] = e_pack(
                    v_line, victim_is_owner ? DIR_SHARED : eff_dstate,
                    victim_is_owner ? -1 : v_owner, v_nsh - 1);
                vsh[vic / 32] = (int32_t)((uint32_t)vsh[vic / 32] &
                                          ~(1u << (vic % 32)));
            } else if (sh_over_m) {
                words[alloc] = e_pack(v_line, DIR_UNCACHED, -1, 0);
                for (int w = 0; w < SW; ++w) vsh[w] = 0;
            }
        }

        // one entry write: the new entry's install (UNCACHED, empty) and
        // the immediate finish; the finish wins where both apply
        if (!dfound || imm) {
            words[alloc] = e_pack(
                !dfound ? rline : v_line,
                imm ? (imm_ex ? DIR_MODIFIED : DIR_SHARED) : DIR_UNCACHED,
                imm_ex ? rreq : -1,
                imm_ex ? 1 : (imm ? n_cur + (had ? 0 : 1) : 0));
            for (int w = 0; w < SW; ++w) {
                uint32_t v = keep ? (uint32_t)vsh[w] : 0u;
                if (imm && rreq / 32 == w) v |= 1u << (rreq % 32);
                vsh[w] = (int32_t)v;
            }
        }
        if (imm) {
            const bool cdata = a.cdata_valid[h] && a.cdata_line[h] == eff_line;
            ready = eff_time + (cdata ? 0 : dram_lat);
            if (cdata) a.cdata_valid[h] = false;
            if constexpr (NET == NET_ZL) {
                a.rep_type[rreq] = (uint8_t)(a.rep_type[rreq] +
                                             (imm_ex ? MSG_EX_REP
                                                     : MSG_SH_REP));
                a.rep_time[rreq] += ready + net_lat_ps(c, h, rreq,
                                                       c.rep_bits, en);
            }
            a.last_line[h] = eff_line;
            a.last_done_ps[h] = ready;
            if (en && !cdata) {
                a.dram_reads[h] += 1;
                a.dram_total_lat[h] += dram_lat;
            }
        }
        if (en) a.dir_accesses[h] += 1;
        atomicAdd(a.progress, 1);
    }

    if constexpr (NET != NET_ZL) {
        // the immediate replies through the contention net, then the
        // fan-outs against the queues they committed
        const int64_t arrival = mem_send<NET>(c, a.n, net_rows, valid, h,
                                              rreq, c.rep_bits, ready, imm,
                                              en);
        if (imm) {
            a.rep_type[rreq] = (uint8_t)(a.rep_type[rreq] +
                                         (imm_ex ? MSG_EX_REP : MSG_SH_REP));
            a.rep_time[rreq] += arrival;
        }
        fan_out<NET, EXT>(a, net_rows, valid, h, fan, bcast, fwd_msg,
                          ovr_col, ovr_msg, eff_line, eff_time, en);
    }
}

template <int NET, bool EXT>
static int launch(const HomeArgs* args, cudaStream_t stream) {
    const int T = (int)args->c.T;
    if (NET == NET_ZL) {
        mem_home_start_kernel<NET, EXT><<<(T + HOMES - 1) / HOMES, HOMES, 0,
                                          stream>>>(*args);
        return (int)cudaGetLastError();
    }
    // a contention net: one CTA, so that every route set sees the
    // queues the set before it committed
    const size_t smem = net_smem(NET, args->n);
    static size_t smem_set = 0;    // the opt-in beyond the static default
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            mem_home_start_kernel<NET, EXT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    mem_home_start_kernel<NET, EXT><<<1, (T + 31) / 32 * 32, smem,
                                      stream>>>(*args);
    return (int)cudaGetLastError();
}

template <bool EXT>
static int launch_net(const HomeArgs* args, cudaStream_t stream) {
    switch ((int)args->c.net_kind) {
        case 2: return launch<NET_HBH, EXT>(args, stream);
        case 3: return launch<NET_ATAC, EXT>(args, stream);
        default: return launch<NET_ZL, EXT>(args, stream);
    }
}

static_assert(sizeof(HomeArgs) == (33 + 1 + 35 + 22) * 8,
              "HomeArgs: 33 pointers, one int, MemConsts and NetConsts");

// MSI full_map: the instantiation without the MOSI and scheme branches;
// it refuses any other protocol or scheme
extern "C" int gt_mem_home_start(const HomeArgs* args, cudaStream_t stream) {
    if (args->c.is_mosi || args->c.scheme != SCHEME_FULL_MAP)
        return (int)cudaErrorInvalidValue;
    return launch_net<false>(args, stream);
}

// MOSI, or a scheme other than full_map (`mem_home_start[ext]`, counted
// apart); it refuses MSI full_map
extern "C" int gt_mem_home_start_ext(const HomeArgs* args,
                                     cudaStream_t stream) {
    if (!args->c.is_mosi && args->c.scheme == SCHEME_FULL_MAP)
        return (int)cudaErrorInvalidValue;
    return launch_net<true>(args, stream);
}
