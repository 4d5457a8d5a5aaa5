// user_mailbox: USER-network sends and receives over the mailbox rings.
//
// Replaces (XLA unit): graphite_tpu/engine/step.py:413-502 (`_net_block`:
// the add-a-delta scatters into the [T, D, T] time/latency rings, the
// head/count bumps, the `_any_src` argmin, the receive gathers and pop,
// the overflow flag) with graphite_tpu/models/network_user.py:96-116
// (`route_latency_ps`).  Plain version: graphite_tpu_torch/ops/
// user_mailbox.py.
//
// One launch, no grid-wide barrier, no atomics.  A receive must see every
// send of the iteration (receives match against the POST-send rings,
// step.py:454-457).  Lane t's receive reads one cell of row t — column
// want = clip(aux0[t]), or 0 when aux0[t] = -1 — or, for a live
// ANY_SENDER receiver (active, at NET_RECV, aux0 = -1), the whole row.  So
// every send s -> d is applied by exactly one thread, chosen by a rule
// both sides evaluate from the same unmodified inputs:
//  - by the RECEIVER of row d when d reads the cell the send writes
//    (d is a live ANY_SENDER receiver, or want(d) == s),
//  - else by the SENDER, whose cell (d, s) no receive reads.
// One warp a row t.  Lane 0 does lane t's send (when the sender applies
// it) and, unless t is a live ANY_SENDER receiver, its receive: it loads
// the want cell and sender want's record together, applies want's send
// to t in registers if there is one, then reads the post-send cell.  A
// live ANY_SENDER row takes the whole warp: lane l applies the sends from
// s = l, l + 32, ... into its own columns, then a warp-wide argmin over
// the post-send row (first index on ties, like jnp.argmin) picks the
// source, and the lane that owns that column pops it.  No two threads
// write one cell, and no thread reads a cell another thread writes (the
// sender's read of head/count of a cell its receiver takes is discarded).
// The overflow flag is only ever set to true: the order of those writes
// cannot matter.
//
// Bound: bytes.  Sends and named receives move a few dozen bytes a lane
// (~64 KB an iteration at T = 1024: nanoseconds at 3.35 TB/s), so the
// launch latency is the floor; the design keeps the chain of dependent
// loads at three (the lane's record; the want cell and the partner's
// record; the post-send ring entry).  An iteration with live ANY_SENDER
// receives reads up to T^2 x (8 + 4 + 4) B = 16 MB (~5 us), only then.
#include "common.cuh"

#define KIND_MAGIC 0
#define KIND_ROUTED 2
#define WARPS 4          // rows (warps) a CTA

struct NetParams {
    int kind, freq_mhz, mesh_width, hop_cycles, flit_bits;
};

// Argument block = graphite_tpu_torch/ops/user_mailbox.py `_pack`.
struct MailboxArgs {
    const int32_t* op;
    const int32_t* aux0;
    const int32_t* aux1;
    const bool* active;
    const int64_t* clock;
    int64_t* time_ps;
    int32_t* lat_ps;
    int32_t* head;
    int32_t* count;
    bool* overflow;
    bool* recv_now;
    int64_t* recv_time;
    int32_t* recv_lat;
    const bool* enabled;
    const int64_t* route_lat;    // [T] under KIND_ROUTED, else null
    int64_t T, D, kind, freq_mhz, mesh_width, hop_cycles, flit_bits;
};

// route_latency_ps (network_user.py): zero-load delay in ps
__device__ int64_t route_latency_ps(int src, int dst, int32_t payload,
                                    bool enabled, const NetParams& p) {
    int64_t cycles;
    if (p.kind == KIND_MAGIC) {
        cycles = 1;
    } else {
        const int w = p.mesh_width;
        const int hops = abs(src % w - dst % w) + abs(src / w - dst / w);
        const int64_t route = (int64_t)hops * p.hop_cycles;
        int64_t ser = 0;
        if (p.flit_bits > 0) {
            // int32 arithmetic, like the int32 payload column
            const int32_t bits = wrap_mul(wrap_add(64, payload), 8);
            ser = floor_div_i32(wrap_add(bits, p.flit_bits - 1),
                                p.flit_bits);
        }
        if (src == dst) ser = 0;
        cycles = enabled ? route + ser : 0;
    }
    return ceil_div_i64(cycles * 1000000, (int64_t)p.freq_mhz);
}

// slot of the oldest entry of a (dst, src) ring: (head - count) mod D,
// truncating like lax.rem, then taken as a Python index (negative wraps)
__device__ __forceinline__ int tail_slot(int32_t head, int32_t count,
                                         int D) {
    int tail = wrap_add(head, -count) % D;
    return tail < 0 ? tail + D : tail;
}

struct Send {          // a send s -> d, applied by one thread
    int64_t time;
    int32_t lat;
    int slot;
};

// append s's packet to ring (d, s) whose head and count the caller holds
template <bool ROUTED>
__device__ __forceinline__ Send push(const MailboxArgs& a,
                                     const NetParams& p, int s, int d,
                                     int32_t payload, int64_t clock,
                                     bool en, int32_t& h, int32_t& c) {
    const int T = (int)a.T, D = (int)a.D;
    const int64_t lat = ROUTED ? a.route_lat[s]
                               : route_latency_ps(s, d, payload, en, p);
    int slot = h % D;
    if (slot < 0) slot += D;
    const size_t cell = ((size_t)d * D + slot) * T + s;
    const Send out{clock + lat, (int32_t)lat, slot};  // int32 wrap
    a.time_ps[cell] = out.time;
    a.lat_ps[cell] = out.lat;
    h = wrap_add(h, 1);
    c = wrap_add(c, 1);
    if (c > D) *a.overflow = true;
    return out;
}

__device__ __forceinline__ bool live_any(int aux0, int op, bool active) {
    return aux0 == -1 && op == OP_NET_RECV && active;
}

// the column lane t's receive reads when it is not a live ANY_SENDER
__device__ __forceinline__ int want_of(int aux0, int T) {
    return aux0 != -1 ? clamp_i32(aux0, 0, T - 1) : 0;
}

__device__ __forceinline__ void write_recv(const MailboxArgs& a, int t,
                                           bool matched, bool now,
                                           int64_t time, int32_t lat) {
    a.recv_time[t] = matched ? time : FAR_FUTURE_PS;
    a.recv_lat[t] = lat;
    a.recv_now[t] = now;
}

template <bool ROUTED>
__global__ void __launch_bounds__(WARPS * 32)
user_mailbox_kernel(const MailboxArgs a) {
    const int T = (int)a.T, D = (int)a.D;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= T) return;
    const NetParams p{(int)a.kind, (int)a.freq_mhz, (int)a.mesh_width,
                      (int)a.hop_cycles, (int)a.flit_bits};
    const bool en = *a.enabled;
    const size_t row = (size_t)t * T;
    // lane t's record (every lane of the warp reads the same words)
    const int op_t = a.op[t], a0 = a.aux0[t];
    const bool act = a.active[t];
    const bool is_recv = op_t == OP_NET_RECV;

    if (!live_any(a0, op_t, act)) {
        if (lane != 0) return;
        // loads of the second round, issued together: lane t's send
        // target, ring (d, t); the want cell; sender want's record
        const bool sends = act && op_t == OP_SEND;
        const int d = clamp_i32(a0, 0, T - 1);
        const int32_t pay_t = a.aux1[t];
        const int64_t clk_t = a.clock[t];
        const int want = want_of(a0, T);
        const size_t rw = row + want;
        int32_t h = a.head[rw], c = a.count[rw];
        const int w_op = a.op[want], w_a0 = a.aux0[want];
        const bool w_act = a.active[want];
        const int32_t w_pay = a.aux1[want];
        const int64_t w_clk = a.clock[want];
        const int d_op = a.op[d], d_a0 = a.aux0[d];
        const bool d_act = a.active[d];
        int32_t hs = a.head[(size_t)d * T + t];
        int32_t cs = a.count[(size_t)d * T + t];
        // lane t's send, unless its receiver d reads that cell
        if (sends && !live_any(d_a0, d_op, d_act) && want_of(d_a0, T) != t) {
            push<ROUTED>(a, p, t, d, pay_t, clk_t, en, hs, cs);
            a.head[(size_t)d * T + t] = hs;
            a.count[(size_t)d * T + t] = cs;
        }
        // want's send to t lands in the cell lane t reads: apply it here
        const bool w_sends = w_act && w_op == OP_SEND &&
                             clamp_i32(w_a0, 0, T - 1) == t;
        Send fresh{0, 0, -1};
        if (w_sends)
            fresh = push<ROUTED>(a, p, want, t, w_pay, w_clk, en, h, c);
        const int tail = tail_slot(h, c, D);
        int64_t time;
        int32_t lat;
        if (tail == fresh.slot) {
            time = fresh.time;
            lat = fresh.lat;
        } else {
            const size_t cell = ((size_t)t * D + tail) * T + want;
            time = a.time_ps[cell];
            lat = a.lat_ps[cell];
        }
        const bool matched = c > 0;
        const bool now = act && is_recv && matched;
        write_recv(a, t, matched, now, time, lat);
        if (w_sends) a.head[rw] = h;
        if (w_sends || now) a.count[rw] = now ? c - 1 : c;
        return;
    }

    // a live ANY_SENDER receiver: the warp takes every send into row t
#pragma unroll 8
    for (int s = lane; s < T; s += 32) {
        // three loads, none behind another (bitwise &, no short circuit)
        const bool ac = a.active[s];
        const int o = a.op[s], x = a.aux0[s];
        if (ac & (o == OP_SEND) & (clamp_i32(x, 0, T - 1) == t)) {
            int32_t h = a.head[row + s], c = a.count[row + s];
            push<ROUTED>(a, p, s, t, a.aux1[s], a.clock[s], en, h, c);
            a.head[row + s] = h;
            a.count[row + s] = c;
        }
    }
    // earliest-arriving oldest entry over the post-send row; each lane
    // reads only its own columns.  Strict < keeps each lane's first
    // (lowest) source; the butterfly keeps the lower source on ties.
    int64_t best = INT64_MAX;
    int best_s = T;
#pragma unroll 8
    for (int s = lane; s < T; s += 32) {
        const int32_t c = a.count[row + s];
        int64_t key = FAR_FUTURE_PS;
        if (c > 0)
            key = a.time_ps[((size_t)t * D +
                             tail_slot(a.head[row + s], c, D)) * T + s];
        if (key < best) { best = key; best_s = s; }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const int64_t ok = __shfl_xor_sync(0xffffffff, best, off);
        const int os = __shfl_xor_sync(0xffffffff, best_s, off);
        if (ok < best || (ok == best && os < best_s)) {
            best = ok; best_s = os;
        }
    }
    if (lane != (best_s & 31)) return;          // the column's owner
    const size_t rc = row + best_s;
    const int32_t c = a.count[rc];
    const size_t cell = ((size_t)t * D + tail_slot(a.head[rc], c, D)) * T
                        + best_s;
    write_recv(a, t, c > 0, c > 0, a.time_ps[cell], a.lat_ps[cell]);
    if (c > 0) a.count[rc] = c - 1;
}

extern "C" int gt_user_mailbox(const MailboxArgs* args,
                               cudaStream_t stream) {
    static_assert(sizeof(MailboxArgs) == 22 * 8,
                  "MailboxArgs: 15 pointers and 7 int64");
    const int T = (int)args->T;
    const int blocks = (T + WARPS - 1) / WARPS;
    if (args->kind == KIND_ROUTED)
        user_mailbox_kernel<true><<<blocks, WARPS * 32, 0, stream>>>(*args);
    else
        user_mailbox_kernel<false><<<blocks, WARPS * 32, 0, stream>>>(*args);
    return (int)cudaGetLastError();
}
