// Device functions shared by the memory-engine kernels (mem_requester,
// mem_home_start, mem_requester_fill).
//
// Replaces the element and row helpers of graphite_tpu/memory/:
// cache_array.py (the packed meta word line << 16 | state << 8 | lru, the
// row lookup / touch / set-state / invalidate / victim / insert, :61-260)
// and engine.py (the sharer-word bit ops and packed directory fields,
// :92-175; the MEMORY network, :227-277; the miss-type and
// line-utilization words, :386-474; the slot decomposition, :602-628).
// Plain versions: graphite_tpu_torch/memory/{cache_array,common}.py.
#pragma once

#include "common.cuh"
#include "net_route.cuh"

// the plain values every memory kernel's argument block ends with
// (graphite_tpu_torch/ops/mem_requester.py `engine_values`)
struct MemConsts {
    int64_t T, line_bits, func_words, unroll, icache_modeling;
    int64_t l1i_rr, l1d_rr, l2_rr, track_mt, track_util;
    int64_t net_kind, net_freq, mesh_w, hop_cycles, flit_bits;
    int64_t req_bits, rep_bits, n_mc;
    int64_t S1I, W1I, S1D, W1D, S2, W2, DS, DW, SW;
    int64_t dram_lat_ps, dir_access_ps, sync_dir_l2_ps, sync_dir_net_ps;
    // the protocol (0 MSI, 1 MOSI), the directory scheme (SCHEME_*), its
    // hardware sharer count k and the limitless trap in ps
    int64_t is_mosi, scheme, max_hw_sharers, trap_ps;
};

// `[dram_directory] directory_type` (memory/params.py `SCHEMES`)
#define SCHEME_FULL_MAP 0
#define SCHEME_LIMITED_NO_BROADCAST 1
#define SCHEME_ACKWISE 2
#define SCHEME_LIMITED_BROADCAST 3
#define SCHEME_LIMITLESS 4

// columns of the per-tile cycle table (memory/common.py MemTiming)
#define CYC_L1I_DAT 0
#define CYC_L1I_TAG 1
#define CYC_L1D_DAT 2
#define CYC_L1D_TAG 3
#define CYC_L2_DAT 4
#define CYC_L2_TAG 5
#define CYC_SYNC_CORE_L1D 6
#define CYC_SYNC_CORE_L1I 7
#define CYC_SYNC_L1D_L2 8
#define CYC_SYNC_L1I_L2 9
#define CYC_SYNC_L2_NET 10
#define N_CYC 11

// message types, directory states, phases, modules, cache states
#define MSG_NONE 0
#define MSG_SH_REQ 1
#define MSG_EX_REQ 2
#define MSG_INV_REQ 3
#define MSG_FLUSH_REQ 4
#define MSG_WB_REQ 5
#define MSG_INV_REP 6
#define MSG_FLUSH_REP 7
#define MSG_WB_REP 8
#define MSG_SH_REP 9
#define MSG_EX_REP 10
#define MSG_NULLIFY 11
#define DIR_UNCACHED 0
#define DIR_SHARED 1
#define DIR_MODIFIED 2
#define DIR_OWNED 3
#define PHASE_IDLE 0
#define PHASE_WAIT_REPLY 1
#define MOD_L1I 1
#define MOD_L1D 2
#define ST_INVALID 0
#define ST_SHARED 1
#define ST_MODIFIED 2
#define ST_OWNED 4
#define MT_FETCHED 0
#define MT_EVICTED 1
#define MT_INVALIDATED 2
#define MT_BITS 65536
#define MT_WORDS 2048

#define FLAG_MEM0_VALID 1
#define FLAG_MEM1_VALID 2
#define FLAG_MEM0_WRITE 4
#define FLAG_MEM1_WRITE 8
#define FLAG_CHECK 64
#define FLAG_SIMPLE_MOV_LOAD 128

// the widest set a kernel holds in registers (ops/ checks the geometry)
#define WMAX 16

#define U32 0xFFFFFFFFLL

// --- time ------------------------------------------------------------------

// cycles -> ps at freq_mhz: ceil(cycles * 1e6 / f) (time_types.py)
__device__ __forceinline__ int64_t cyc_ps(int64_t cycles, int64_t f) {
    return ceil_div_i64(cycles * 1000000LL, f);
}

// the per-tile cycle count `col` at the tile's frequency, 0 while models
// are off (engine.py ccycles)
__device__ __forceinline__ int64_t ccyc(const int64_t* cyc, int t, int col,
                                        int64_t f, bool en) {
    return en ? cyc_ps(cyc[(size_t)t * N_CYC + col], f) : 0;
}

// --- the MEMORY network (zero-load hop counter, or magic) -------------------

__device__ __forceinline__ int64_t net_lat_ps(const MemConsts& c, int64_t src,
                                              int64_t dst, int64_t bits,
                                              bool en) {
    if (!en) return 0;
    if (c.net_kind == 0) return cyc_ps(1, c.net_freq);
    const int64_t w = c.mesh_w;
    const int64_t dx = src % w - dst % w, dy = src / w - dst / w;
    const int64_t hops = (dx < 0 ? -dx : dx) + (dy < 0 ? -dy : dy);
    const int64_t flits = (bits + c.flit_bits - 1) / c.flit_bits;
    return cyc_ps(hops * c.hop_cycles + (src == dst ? 0 : flits), c.net_freq);
}

// One coherence message a thread through the MEMORY net (`mem_net_send`,
// graphite_tpu/memory/engine.py:251-277): under NET_ZL t0 plus the
// zero-load latency (no barrier); under NET_HBH / NET_ATAC the contention
// route of net_route.cuh, which every thread of the one-CTA kernel must
// reach (`smem`: the ATAC hub rows' shared memory).  A packet that is
// masked out (or any packet while models are off) arrives at t0 and
// leaves the queues as they were.
template <int NET>
__device__ __forceinline__ int64_t mem_send(const MemConsts& c,
                                            const NetConsts& n,
                                            long long* smem, bool valid,
                                            int src, int dst, int64_t bits,
                                            int64_t t0, bool mask, bool en) {
    if constexpr (NET == NET_HBH) {
        return hbh_send(n, src, dst, bits, t0, valid && mask && en);
    } else if constexpr (NET == NET_ATAC) {
        return atac_send(n, smem, valid, src, dst, bits, t0, mask, en);
    } else {
        return t0 + net_lat_ps(c, src, dst, bits, en);
    }
}

// the dynamic shared memory of a kernel instantiation (the ATAC hub rows)
__host__ __forceinline__ size_t net_smem(int net, const NetConsts& n) {
    return net == NET_ATAC && n.contention
        ? (size_t)(2 * n.C + 1) * N_COLS * sizeof(long long) : 0;
}

// --- packed cache meta words -------------------------------------------------

__device__ __forceinline__ int32_t m_tag(int64_t m) { return (int32_t)(m >> 16); }
__device__ __forceinline__ int m_st(int64_t m) { return (int)((m >> 8) & 0xFF); }
__device__ __forceinline__ int m_lru(int64_t m) { return (int)(m & 0xFF); }
__device__ __forceinline__ int64_t m_pack(int64_t line, int st, int lru) {
    return (int64_t)((uint64_t)line << 16) | ((int64_t)st << 8) | lru;
}

__device__ __forceinline__ bool st_readable(int s) {
    return s == ST_SHARED || s == ST_MODIFIED || s == 3 || s == ST_OWNED;
}
__device__ __forceinline__ bool st_writable(int s) {
    return s == ST_MODIFIED || s == 3;
}

// line mod sets: truncating for lines >= 0, flooring for a victim's -1
__device__ __forceinline__ int64_t set_of(int64_t line, int64_t sets) {
    const int64_t r = line % sets;
    return r < 0 ? r + sets : r;
}

// One lane's set row of one cache level, in registers.
struct Row {
    int64_t m[WMAX];
    int W;                 // the level's (max) way count
    int64_t set;
    int64_t* base;         // &meta[t, set, 0]
};

__device__ __forceinline__ void row_load(Row& r, int64_t* meta, int t,
                                         int64_t S, int W, int64_t set) {
    r.W = W;
    r.set = set;
    r.base = meta + ((size_t)t * S + set) * W;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        if (w < W) r.m[w] = r.base[w];
}

__device__ __forceinline__ void row_store(const Row& r) {
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        if (w < r.W) r.base[w] = r.m[w];
}

// (hit, way, state) of `line`: the first valid way holding it
__device__ __forceinline__ bool row_lookup(const Row& r, int32_t line,
                                           int& way, int& st) {
    way = 0;
    st = ST_INVALID;
#pragma unroll
    for (int w = WMAX - 1; w >= 0; --w)
        if (w < r.W && m_tag(r.m[w]) == line && m_st(r.m[w]) != ST_INVALID) {
            way = w;
            st = m_st(r.m[w]);
        }
    return st != ST_INVALID;
}

__device__ __forceinline__ void row_touch(Row& r, int way, bool mask) {
    if (!mask) return;
    int rank = 0;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        if (w == way) rank = m_lru(r.m[w]);
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
        if (w >= r.W) continue;
        const int l = m_lru(r.m[w]);
        const int nl = w == way ? 0 : l + (l < rank ? 1 : 0);
        r.m[w] = (r.m[w] & ~0xFFLL) | nl;
    }
}

__device__ __forceinline__ void row_set_state(Row& r, int way, int st,
                                              bool mask) {
    if (!mask) return;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        if (w == way) r.m[w] = (r.m[w] & ~0xFF00LL) | ((int64_t)st << 8);
}

__device__ __forceinline__ void row_invalidate(Row& r, int32_t line,
                                               bool mask) {
    int way, st;
    const bool hit = row_lookup(r, line, way, st);
    row_set_state(r, way, ST_INVALID, mask && hit);
}

// Victim (cache_array.py row_pick_victim): LRU takes the first invalid
// usable way, else the max-rank usable way (first on ties); round robin
// takes the max-rank usable way whatever its state.  `ways` masks the
// padded ways of a smaller per-tile geometry.
__device__ __forceinline__ int row_victim(const Row& r, bool rr, int ways,
                                          bool& valid, int32_t& vline,
                                          int& vst) {
    int lru_way = 0, best = -2, inv_way = -1;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
        if (w >= r.W) continue;
        const bool usable = w < ways;
        const int l = usable ? m_lru(r.m[w]) : -1;
        if (l > best) { best = l; lru_way = w; }
        if (usable && inv_way < 0 && m_st(r.m[w]) == ST_INVALID) inv_way = w;
    }
    int way;
    if (rr) {
        way = lru_way;
    } else {
        way = inv_way >= 0 ? inv_way : lru_way;
    }
    int64_t m = 0;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        if (w == way) m = r.m[w];
    vst = m_st(m);
    vline = m_tag(m);
    valid = rr ? vst != ST_INVALID : inv_way < 0;
    return way;
}

__device__ __forceinline__ void row_insert(Row& r, int32_t line, int way,
                                           int st, bool mask) {
    if (!mask) return;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
        if (w == way) r.m[w] = m_pack(line, st, m_lru(r.m[w]));
    row_touch(r, way, true);
}

// the lowest set bit of an entry's sharer words, -1 when none (the
// deterministic getOneSharer); `skip`: a tile left out
__device__ __forceinline__ int lowest_sharer(const int32_t* sh, int SW,
                                             int skip) {
    for (int w = 0; w < SW; ++w) {
        uint32_t b = (uint32_t)sh[w];
        if (skip >= 0 && skip / 32 == w) b &= ~(1u << (skip % 32));
        if (b) return w * 32 + __ffs(b) - 1;
    }
    return -1;
}

// --- miss-type bitmaps: int64 words holding uint32 bits ---------------------

__device__ __forceinline__ int64_t* mt_word(int64_t* mt, int t, int row,
                                            int64_t line, int& bit) {
    const int64_t h = (line & U32) & (MT_BITS - 1);
    bit = (int)(h % 32);
    return mt + ((size_t)t * 3 + row) * MT_WORDS + h / 32;
}

__device__ __forceinline__ bool mt_test(int64_t* mt, int t, int row,
                                        int64_t line) {
    int bit;
    return (*mt_word(mt, t, row, line, bit) >> bit) & 1;
}

__device__ __forceinline__ void mt_set(int64_t* mt, int t, int row,
                                       int64_t line, bool val, bool mask) {
    if (!mask) return;
    int bit;
    int64_t* w = mt_word(mt, t, row, line, bit);
    *w = val ? (*w | (1LL << bit)) : (*w & ~(1LL << bit));
}

// --- L2 line utilization: reads (low 16) | writes << 16 ---------------------

__device__ __forceinline__ int64_t util_inc(int64_t cur, bool is_write,
                                            bool mask) {
    const int64_t fld = is_write ? cur >> 16 : cur & 0xFFFF;
    return (mask && fld < 0xFFFF) ? cur + (is_write ? (1LL << 16) : 1) : cur;
}

// histogram a departing line's counter (bucket = bit length, at most 7)
__device__ __forceinline__ void util_classify(int64_t* hist, int64_t* reads,
                                              int64_t* writes, int t,
                                              int64_t v, bool m) {
    if (!m) return;
    const int64_t rd = v & 0xFFFF, wr = v >> 16;
    const uint32_t total = (uint32_t)(rd + wr);
    const int b = min(7, 32 - __clz((int)total));
    hist[(size_t)t * 8 + b] += 1;
    reads[t] += rd;
    writes[t] += wr;
}

// --- the record's memory slots ----------------------------------------------

// first present slot >= slot among [icache, mem0, mem1], else 3
__device__ __forceinline__ int next_slot(const MemConsts& c, int op,
                                         int flags, bool en, int slot) {
    const bool p0 = c.icache_modeling && en && (op < 15 || op == OP_BBLOCK);
    const bool p1 = (flags & FLAG_MEM0_VALID) != 0;
    const bool p2 = (flags & FLAG_MEM1_VALID) != 0;
    if (slot <= 0 && p0) return 0;
    if (slot <= 1 && p1) return 1;
    if (slot <= 2 && p2) return 2;
    return 3;
}

// the functional store's stamped write: the highest writing lane of a
// phase wins a word (the JAX scatter's order on the CPU); a packed
// (lane + 1) << 32 | value is atomicMax'ed into the word, and cleared back
// to the value once every write of the phase landed (func_settle)
__device__ __forceinline__ void func_write(int64_t* fm, int64_t word, int t,
                                           int64_t value) {
    atomicMax((unsigned long long*)(fm + word),
              ((unsigned long long)(t + 1) << 32) | (unsigned long long)value);
}

__device__ __forceinline__ int64_t func_read(const int64_t* fm,
                                             int64_t word) {
    return *(volatile const int64_t*)(fm + word) & U32;
}
