// The contention NoCs' routes as device functions, shared by the USER
// net's kernels (noc_route, atac_route) and the MEMORY net's (the three
// memory-engine kernels and mem_net_route).
//
// Plain versions: graphite_tpu_torch/models/network_hop_by_hop.py
// (route_hop_by_hop_plain), models/network_atac.py (route_atac_plain,
// atac_zeroload_ps), models/queue_models.py (scatter_queue_delay) and
// memory/net.py (mem_net_send, mem_net_fanout).
//
// emesh_hop_by_hop.  A packet's XY path is its INJECT cell, the
// horizontal run along the source row, the vertical run along the
// destination column and the SELF cell; every cell reads the PRE-call
// port queues, and a cell's read time is the max-plus closed form of the
// serial hop recurrence, walked as ONE loop over the cells (`Path`; the
// same walk written as three loops, one a run, lost an accumulation on
// the card).  Each visited cell folds its member's terms into that port
// row's accumulators with 64-bit reductions (`red`, no result awaited);
// after a barrier, each touched row folds its accumulators into the
// queue and clears them (`hbh_fold_row`).  `hbh_send` is that route for
// one CTA whose threads hold one packet each: walk, fence and barrier,
// fold, fence and barrier — the accumulators live in a global scratch
// ([w * h * 6, N_ACC] int64, zero between calls).
//
// ATAC.  The hub queues ((2C + 1) rows: send hubs, receive hubs, a
// scratch row) are staged in shared memory; `scatter_delay` is
// `scatter_queue_delay` over them (every lane reads its pre-call row; a
// scatter-max of in-window arrivals into the queue time, a barrier, a
// scatter-add of their processing times, a barrier, then the window
// start from the committed queue time and the moment sums), with
// shared-memory 64-bit atomics (integer max and add commute, so the
// result does not depend on their order).  `atac_send` is one packet a
// thread of one CTA: stage, the send hub, the receive hub, write back.
#pragma once

#include "queue_common.cuh"

// the MEMORY net's kinds (a kernel's template parameter)
#define NET_ZL 0      // magic or emesh_hop_counter: the zero-load latency
#define NET_HBH 1     // emesh_hop_by_hop
#define NET_ATAC 2    // atac

#define PORT_RIGHT 0
#define PORT_LEFT 1
#define PORT_UP 2
#define PORT_DOWN 3
#define PORT_SELF 4
#define PORT_INJECT 5
#define NEG_INF (-(1LL << 61))
#define WIN_FLOOR (-(1LL << 62))

// per (cell, port) accumulators of one route (ops/noc_route.py N_ACC)
#define A_CNT 0        // members
#define A_PROC 1       // sum of members' processing times
#define A_PROC2 2      // sum of their squares
#define A_DELAY 3      // sum of members' delays
#define A_ANA 4        // members too old (the M/G/1 fallback)
#define A_NEWEST 5     // max of arr + delay + proc (floor 0)
#define A_WIN 6        // members in window
#define A_ARR 7        // max in-window arrival (floor 0; arrivals >= 0)
#define A_WPROC 8      // sum of in-window processing times
#define N_ACC 9

// The MEMORY net's contention model, the tail of every memory kernel's
// argument block (graphite_tpu_torch/ops/mem_net_route.py `net_values`).
struct NetConsts {
    int64_t* q;            // [N, 10] queue rows (hbh T * 6 + 1, atac 2C + 1)
    long long* scratch;    // hbh: [w * h * 6, N_ACC], zero between calls
    int64_t freq, flit_bits, history, analytical, span, contention;
    int64_t w, h, router_delay, link_delay;                    // hbh
    int64_t C, cw, ch, enet_hop, send_hub, recv_hub, from_hub_ps,
        optical_ps, distance_based, threshold;                  // atac
};

// reductions into the accumulators: `red` returns nothing, so a thread
// does not wait for its atomics (atomicAdd compiles to a returning ATOMG)
__device__ __forceinline__ void red_add(long long* p, long long v) {
    asm volatile("red.global.add.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_max(long long* p, long long v) {
    asm volatile("red.global.max.s64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// a load from L2 (where the reductions were performed), which the
// compiler keeps after the barrier
__device__ __forceinline__ long long ld_l2(const long long* p) {
    long long v;
    asm volatile("ld.global.cg.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// --- emesh_hop_by_hop ---------------------------------------------------------

// one packet's XY path: the queue row of its c-th cell
struct Path {
    int w, sx, sy, dx, nh, dist, sgx, sgy, ph, pv, self_row;

    __device__ __forceinline__ Path(int w_, int src, int dst)
        : w(w_), sx(src % w_), sy(src / w_), dx(dst % w_) {
        const int dy = dst / w_;
        nh = abs(dx - sx);
        dist = nh + abs(dy - sy);
        sgx = dx > sx ? 1 : -1;
        sgy = dy > sy ? 1 : -1;
        ph = dx > sx ? PORT_RIGHT : PORT_LEFT;
        pv = dy > sy ? PORT_UP : PORT_DOWN;
        self_row = (dy * w_ + dx) * 6 + PORT_SELF;
    }

    __device__ __forceinline__ int row(int c) const {
        if (c == 0) return (sy * w + sx) * 6 + PORT_INJECT;
        if (c <= nh) return (sy * w + sx + (c - 1) * sgx) * 6 + ph;
        if (c <= dist) return ((sy + (c - 1 - nh) * sgy) * w + dx) * 6 + pv;
        return self_row;
    }
};

// The delay of one member cell (queue row `row`; `r` its first six
// columns: queue time, window start and the M/G/1 moments); folds the
// member's terms into the row's accumulators.  `hist_ana`: a history
// queue with the analytical fallback.
template <typename W>
__device__ __forceinline__ int64_t hbh_visit(long long* scratch,
                                             bool hist_ana, int row,
                                             const W* r, int64_t arr,
                                             int64_t proc) {
    const int64_t qt = r[COL_QT];
    const bool too_old = hist_ana && arr + proc < r[COL_WS];
    const int64_t dly = too_old
        ? mg1_wait(r[COL_N_ARR], r[COL_SUM_ST], r[COL_SUM_ST2],
                   r[COL_NEWEST])
        : (qt - arr > 0 ? qt - arr : 0);
    long long* acc = scratch + (size_t)row * N_ACC;
    red_add(acc + A_CNT, 1);
    red_add(acc + A_PROC, proc);
    red_add(acc + A_PROC2, proc * proc);
    red_add(acc + A_DELAY, dly);
    red_max(acc + A_NEWEST, arr + dly + proc);
    if (too_old) {
        red_add(acc + A_ANA, 1);
    } else {
        red_add(acc + A_WIN, 1);
        red_max(acc + A_ARR, arr);
        red_add(acc + A_WPROC, proc);
    }
    return dly;
}

// Fold one port row's accumulators `v` (A_CNT > 0) into its queue row
// (`_dense_contention` :332-374: queue time and window start only when a
// member is in window; newest, moments, requests, utilization, delay and
// the analytical count over every member).
__device__ __forceinline__ void hbh_fold_row(int64_t* r, const int64_t* v,
                                             int64_t span) {
    const int64_t cnt = v[A_CNT];
    int64_t qt = r[COL_QT], ws = r[COL_WS];
    if (v[A_WIN] > 0) {
        qt = (qt > v[A_ARR] ? qt : v[A_ARR]) + v[A_WPROC];
        if (qt - span > ws) ws = qt - span;
    }
    r[COL_QT] = qt;
    r[COL_WS] = ws;
    if (v[A_NEWEST] > r[COL_NEWEST]) r[COL_NEWEST] = v[A_NEWEST];
    r[COL_SUM_ST] += v[A_PROC];
    r[COL_SUM_ST2] += v[A_PROC2];
    r[COL_N_ARR] += cnt;
    r[COL_REQS] += cnt;
    r[COL_UTIL] += v[A_PROC];
    r[COL_DELAY] += v[A_DELAY];
    r[COL_ANA] += v[A_ANA];
}

// One packet's walk: the sum of its cells' delays (network cycles), each
// cell's terms folded into the accumulators.  Reads the queue rows `q`
// from global memory.
__device__ __noinline__ int64_t hbh_walk(const int64_t* q, long long* scratch,
                                         bool hist_ana, int64_t router_delay,
                                         int64_t step, const Path p,
                                         int64_t t0, int64_t proc) {
    int64_t cont = 0, base = 0, carry = 0, run = NEG_INF;
#pragma unroll 1
    for (int c = 0; c < p.dist + 2; ++c) {
        int64_t arr;
        if (c == 0) {
            arr = t0;
        } else if (c <= p.nh) {
            arr = (c - 1) * step + (base > run ? base : run);
        } else {
            if (c == p.nh + 1) {   // leaving the horizontal run
                carry = base > run ? base : run;
                run = NEG_INF;
            }
            arr = (c <= p.dist ? (c - 1) * step : p.dist * step) +
                  (carry > run ? carry : run);
        }
        const int row = p.row(c);
        const int64_t* r = q + (size_t)row * N_COLS;
        const int64_t qt = r[COL_QT];
        const int64_t dly = hbh_visit(scratch, hist_ana, row, r, arr, proc);
        cont += dly;
        if (c == 0) {
            base = t0 + router_delay + dly;
        } else if (c <= p.dist && qt - (c - 1) * step > run) {
            run = qt - (c - 1) * step;
        }
    }
    return cont;
}

// Every touched port row of a one-CTA route folds its accumulators into
// the queue and clears them; between two barriers of the whole block.
__device__ __forceinline__ void hbh_fold_block(const NetConsts& n) {
    const int R = (int)(n.w * n.h * 6);
    for (int row = threadIdx.x; row < R; row += blockDim.x) {
        long long* acc = n.scratch + (size_t)row * N_ACC;
        if (ld_l2(acc + A_CNT) == 0) continue;
        int64_t v[N_ACC];
#pragma unroll
        for (int k = 0; k < N_ACC; ++k) v[k] = ld_l2(acc + k);
        hbh_fold_row(n.q + (size_t)row * N_COLS, v, n.span);
#pragma unroll
        for (int k = 0; k < N_ACC; ++k) acc[k] = 0;
    }
}

// Route one packet a thread (`live`: masked in and models enabled) of
// one CTA; every thread of the block calls it.  Returns the arrival in
// ps (t0 for a packet that is not live).
__device__ __forceinline__ int64_t hbh_send(const NetConsts& n, int src,
                                            int dst, int64_t bits, int64_t t0,
                                            bool live) {
    int64_t flits = floor_div_i64(bits + n.flit_bits - 1, n.flit_bits);
    if (flits < 1) flits = 1;
    const int64_t t0c = ps_to_cyc(t0, n.freq);
    const Path p((int)n.w, src, dst);
    const int64_t step = n.router_delay + n.link_delay;
    int64_t cont = 0;
    if (n.contention) {
        if (live)
            cont = hbh_walk(n.q, n.scratch, n.history && n.analytical,
                            n.router_delay, step, p, t0c, flits);
        __threadfence();          // this thread's reductions are performed
        __syncthreads();          // every read of the queues is done
        hbh_fold_block(n);
        __threadfence();
        __syncthreads();          // the queues are committed
    }
    if (!live) return t0;
    const int64_t t = t0c + n.router_delay + (p.dist + 1) * step + cont +
                      (src == dst ? 0 : flits);
    return cyc_to_ps(t, n.freq);
}

// The scatter form of one queue charge on a row no other lane of the
// call addresses (`scatter_queue_delay` for unique rows): returns the
// delay and commits the row; `go` false touches nothing.
__device__ int64_t unique_charge(int64_t* r, bool hist_ana, int64_t span,
                                 int64_t pkt, int64_t proc, bool go) {
    if (!go) return 0;
    if (proc < 1) proc = 1;
    const int64_t qt = r[COL_QT];
    const bool too_old = hist_ana && pkt + proc < r[COL_WS];
    const int64_t delay = too_old
        ? mg1_wait(r[COL_N_ARR], r[COL_SUM_ST], r[COL_SUM_ST2],
                   r[COL_NEWEST])
        : (qt - pkt > 0 ? qt - pkt : 0);
    if (!too_old) {
        const int64_t qt_new = (qt > pkt ? qt : pkt) + proc;
        r[COL_QT] = qt_new;
        if (qt_new - span > r[COL_WS]) r[COL_WS] = qt_new - span;
    }
    const int64_t end = pkt + delay + proc;
    if (end > r[COL_NEWEST]) r[COL_NEWEST] = end;
    r[COL_SUM_ST] += proc;
    r[COL_SUM_ST2] += proc * proc;
    r[COL_N_ARR] += 1;
    r[COL_REQS] += 1;
    r[COL_UTIL] += proc;
    r[COL_DELAY] += delay;
    if (too_old) r[COL_ANA] += 1;
    return delay;
}

// The masked lanes' terms of a scatter call on its scratch row (a max
// with 0, with WIN_FLOOR and with 0; adds of 0).
template <typename W>
__device__ __forceinline__ void scratch_terms(W* s) {
    if (s[COL_QT] < 0) s[COL_QT] = 0;
    if (s[COL_WS] < WIN_FLOOR) s[COL_WS] = WIN_FLOOR;
    if (s[COL_NEWEST] < 0) s[COL_NEWEST] = 0;
}

// --- ATAC ---------------------------------------------------------------------

struct Lane {
    bool valid;     // a thread with a lane (t < T)
    bool mask;      // this call's mask
    int qid;        // its hub row (the scratch row when masked)
    int64_t pkt;    // arrival at the hub, network cycles
    int64_t proc;   // processing (serialization) cycles, >= 1
};

// shared-memory 64-bit integer atomics on long long words
__device__ __forceinline__ void atomic_add_ll(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

__device__ __forceinline__ void atomic_max_ll(long long* p, long long v) {
    atomicMax(p, v);
}

// `scatter_queue_delay` over the staged rows (scratch row `scratch_row`);
// every thread of the block calls it (the barriers).  Returns the lane's
// delay (0 when masked).
__device__ int64_t scatter_delay(long long* rows, int scratch_row,
                                 bool hist_ana, int64_t span,
                                 const Lane& ln) {
    long long* r = rows + ln.qid * N_COLS;
    int64_t delay = 0;
    bool too_old = false;
    if (ln.valid) {
        const int64_t qt = r[COL_QT];
        too_old = hist_ana && ln.pkt + ln.proc < r[COL_WS];
        delay = too_old ? mg1_wait(r[COL_N_ARR], r[COL_SUM_ST],
                                   r[COL_SUM_ST2], r[COL_NEWEST])
                        : (qt - ln.pkt > 0 ? qt - ln.pkt : 0);
    }
    const bool in_win = ln.mask && !too_old;
    // every lane's read of the pre-call row is done; the masked lanes'
    // terms all land on the scratch row
    const int any_masked = __syncthreads_or(ln.valid && !ln.mask);
    if (ln.mask) atomic_max_ll(r + COL_QT, in_win ? ln.pkt : 0);
    __syncthreads();
    if (in_win) atomic_add_ll(r + COL_QT, ln.proc);
    __syncthreads();
    if (ln.mask) {
        const int64_t qt_new = r[COL_QT];
        atomic_max_ll(r + COL_WS, in_win ? qt_new - span : WIN_FLOOR);
        atomic_max_ll(r + COL_NEWEST, ln.pkt + delay + ln.proc);
        atomic_add_ll(r + COL_SUM_ST, ln.proc);
        atomic_add_ll(r + COL_SUM_ST2, ln.proc * ln.proc);
        atomic_add_ll(r + COL_N_ARR, 1);
        atomic_add_ll(r + COL_REQS, 1);
        atomic_add_ll(r + COL_UTIL, ln.proc);
        atomic_add_ll(r + COL_DELAY, delay);
        if (too_old) atomic_add_ll(r + COL_ANA, 1);
    }
    if (any_masked && threadIdx.x == 0)
        scratch_terms(rows + scratch_row * N_COLS);
    __syncthreads();
    return ln.mask ? delay : 0;
}

// The mesh and cluster geometry of an ATAC net.
struct AtacGeo {
    int w, cw, ch;
    int64_t enet_hop, freq, distance_based, threshold;

    __device__ __forceinline__ int hops(int a, int b) const {
        return abs(a % w - b % w) + abs(a / w - b / w);
    }
    __device__ __forceinline__ int cluster(int t) const {
        return (t / w) / ch * (w / cw) + (t % w) / cw;
    }
    __device__ __forceinline__ int hub(int c) const {
        const int per_row = w / cw;
        return (c / per_row) * ch * w + (c % per_row) * cw;
    }
    // the packet rides the ONet (`atac_use_onet`)
    __device__ __forceinline__ bool onet(int s, int d) const {
        bool enet = cluster(s) == cluster(d);
        if (distance_based) enet = enet || hops(s, d) <= threshold;
        return !enet;
    }
    __device__ __forceinline__ int64_t enet_ps(int s, int d) const {
        return cyc_to_ps((int64_t)hops(s, d) * enet_hop, freq);
    }
};

__device__ __forceinline__ AtacGeo atac_geo(const NetConsts& n) {
    return AtacGeo{(int)n.w, (int)n.cw, (int)n.ch, n.enet_hop, n.freq,
                   n.distance_based, n.threshold};
}

// Stage the hub rows into shared memory / write them back; every thread
// of the block calls both (a barrier after each).
__device__ __forceinline__ void atac_stage(const NetConsts& n,
                                           long long* rows) {
    const int nw = (int)(2 * n.C + 1) * N_COLS;
    for (int k = threadIdx.x; k < nw; k += blockDim.x) rows[k] = n.q[k];
    __syncthreads();
}

__device__ __forceinline__ void atac_commit(const NetConsts& n,
                                            const long long* rows) {
    const int nw = (int)(2 * n.C + 1) * N_COLS;
    for (int k = threadIdx.x; k < nw; k += blockDim.x) n.q[k] = rows[k];
    __syncthreads();
}

// `route_atac` for one packet a thread of one CTA over the staged hub
// rows (the send hubs against the pre-call state, then the receive hubs
// against the committed send hubs); every thread calls it.  `flits` is
// the packet's flit count (not clamped; the hub service takes at least
// one cycle).  Returns the route latency in ps (0 when masked).
__device__ __forceinline__ int64_t atac_route_lane(const NetConsts& n, long long* rows,
                                   bool valid, int src, int dst,
                                   int64_t flits, int64_t clk, bool mask,
                                   bool en) {
    const AtacGeo g = atac_geo(n);
    const int C = (int)n.C;
    const bool use_onet = valid && mask && g.onet(src, dst);
    const bool onet_live = use_onet && en;
    const int csrc = g.cluster(src), cdst = g.cluster(dst);
    const int64_t sendhub_arrive =
        clk + cyc_to_ps((int64_t)g.hops(src, g.hub(csrc)) * n.enet_hop,
                        n.freq);
    const int64_t proc = flits > 1 ? flits : 1;
    const bool hist_ana = n.history && n.analytical;
    int64_t delay1 = 0, delay2 = 0;
    if (n.contention) {
        const Lane l1{valid, onet_live, onet_live ? csrc : 2 * C,
                      ps_to_cyc(sendhub_arrive, n.freq), proc};
        delay1 = scatter_delay(rows, 2 * C, hist_ana, n.span, l1);
    }
    const int64_t recvhub_arrive =
        sendhub_arrive + cyc_to_ps(delay1 + n.send_hub, n.freq) +
        (en ? n.optical_ps : 0);
    if (n.contention) {
        const Lane l2{valid, onet_live, onet_live ? C + cdst : 2 * C,
                      ps_to_cyc(recvhub_arrive, n.freq), proc};
        delay2 = scatter_delay(rows, 2 * C, hist_ana, n.span, l2);
    }
    const int64_t recvhub_done =
        recvhub_arrive + cyc_to_ps(delay2 + n.recv_hub, n.freq);
    const int64_t onet_ps = (recvhub_done - clk) + n.from_hub_ps;
    const int64_t ser_ps = src == dst ? 0 : cyc_to_ps(flits, n.freq);
    const int64_t total =
        en ? (use_onet ? onet_ps : g.enet_ps(src, dst)) + ser_ps : 0;
    return mask ? total : 0;
}

// One packet a thread of one CTA through the MEMORY net's ATAC: stage,
// route, commit.  Returns the arrival in ps (t0 when masked).
__device__ __forceinline__ int64_t atac_send(const NetConsts& n,
                                             long long* rows, bool valid,
                                             int src, int dst, int64_t bits,
                                             int64_t t0, bool mask, bool en) {
    if (n.contention) atac_stage(n, rows);
    const int64_t flits = floor_div_i64(bits + n.flit_bits - 1, n.flit_bits);
    const int64_t lat = atac_route_lane(n, rows, valid, src, dst, flits, t0,
                                        mask, en);
    if (n.contention) atac_commit(n, rows);
    return t0 + lat;
}

// `atac_zeroload_ps`: what the route charges on idle hubs, 0 while models
// are disabled.
__device__ __forceinline__ int64_t atac_zeroload(const NetConsts& n,
                                                 const AtacGeo& g, int s,
                                                 int d, int64_t flits,
                                                 bool en) {
    if (!en) return 0;
    const int64_t ser = s == d ? 0 : cyc_to_ps(flits, n.freq);
    if (!g.onet(s, d)) return g.enet_ps(s, d) + ser;
    const int64_t to_hub = g.enet_ps(s, g.hub(g.cluster(s)));
    return to_hub + cyc_to_ps(n.send_hub, n.freq) + n.optical_ps +
           cyc_to_ps(n.recv_hub, n.freq) + n.from_hub_ps + ser;
}
