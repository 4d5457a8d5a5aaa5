// A home's fan-out through a contention MEMORY net, shared by the
// home-start kernels of both engines (mem_home_start, shl2_home_start).
//
// Replaces (XLA unit): graphite_tpu/memory/engine.py:280-374
// (`mem_net_fanout`) where the home starts call it: the INV / FLUSH / WB
// copies into the home's FWD column fwd[target, home], one a set bit of
// the target words `word(w)` (by tile id), each copy's message `msg(s)`
// and its arrival from its rank among the targets.  emesh_hop_by_hop:
// one charge of k * flits on the home's INJECT row (its own row, so no
// two homes collide), then rank * flits and the zero-load path.  ATAC:
// one charge of k_onet * flits on the cluster's send hub (homes of one
// cluster collide there: the scatter form), its delay on the ONet copies
// only, rank * flits and the ATAC zero-load path.  Every thread of the
// block calls it (the queue commit).  Plain version:
// graphite_tpu_torch/memory/net.py `mem_net_fanout`.
#pragma once

#include "mem_common.cuh"

template <int NET, typename Word, typename Msg>
__device__ __forceinline__ void fan_out_routed(
        const MemConsts& c, const NetConsts& n, long long* rows, bool valid,
        int h, bool fan, Word word, Msg msg, uint8_t* fwd_type,
        int32_t* fwd_line, int64_t* fwd_time, int32_t eff_line,
        int64_t eff_time, bool en) {
    const int T = (int)c.T, SW = (int)c.SW;
    const int64_t flits_raw =
        floor_div_i64(c.req_bits + n.flit_bits - 1, n.flit_bits);
    const int64_t flits = flits_raw > 1 ? flits_raw : 1;
    int64_t delay = 0;
    if constexpr (NET == NET_HBH) {
        int k = 0;
        if (fan)
            for (int w = 0; w < SW; ++w)
                for (uint32_t b = word(w); b; b &= b - 1)
                    k += w * 32 + __ffs(b) - 1 < T;
        if (n.contention) {
            // a fan-out with no target charges nothing (`mem_net_fanout`
            // masks the homes whose send row is empty)
            const bool go = fan && k > 0 && en;
            delay = unique_charge(n.q + ((size_t)h * 6 + PORT_INJECT) * N_COLS,
                                  n.history && n.analytical, n.span,
                                  ps_to_cyc(eff_time, n.freq), k * flits, go);
            if (__syncthreads_or(valid && !go) && threadIdx.x == 0)
                scratch_terms(n.q + (size_t)T * 6 * N_COLS);
        }
    } else if constexpr (NET == NET_ATAC) {
        const AtacGeo g = atac_geo(n);
        int k_onet = 0;
        if (fan)
            for (int w = 0; w < SW; ++w)
                for (uint32_t b = word(w); b; b &= b - 1) {
                    const int s = w * 32 + __ffs(b) - 1;
                    k_onet += s < T && g.onet(h, s);
                }
        if (n.contention) {
            atac_stage(n, rows);
            const bool go = fan && k_onet > 0 && en;
            const Lane ln{valid, go, go ? g.cluster(h) : 2 * (int)n.C,
                          ps_to_cyc(eff_time, n.freq),
                          k_onet * flits > 1 ? k_onet * flits : 1};
            delay = scatter_delay(rows, 2 * (int)n.C,
                                  n.history && n.analytical, n.span, ln);
            atac_commit(n, rows);
        }
    }
    if (!fan) return;
    int rank = 0;
    for (int w = 0; w < SW; ++w) {
        for (uint32_t bits = word(w); bits; bits &= bits - 1) {
            const int s = w * 32 + __ffs(bits) - 1;
            if (s >= T) break;
            int64_t arrival = 0;
            if constexpr (NET == NET_HBH) {
                const int w_ = (int)n.w;
                const int64_t hops = abs(h % w_ - s % w_) + abs(h / w_ - s / w_);
                const int64_t step = n.router_delay + n.link_delay;
                const int64_t zl = n.router_delay + (hops + 1) * step +
                                   (h == s ? 0 : flits);
                arrival = eff_time + cyc_to_ps(
                    en ? zl + delay + rank * flits : 0, n.freq);
            } else if constexpr (NET == NET_ATAC) {
                const AtacGeo g = atac_geo(n);
                const int64_t extra =
                    rank * flits + (g.onet(h, s) ? delay : 0);
                arrival = eff_time + atac_zeroload(n, g, h, s, flits_raw, en) +
                          cyc_to_ps(en ? extra : 0, n.freq);
            }
            const size_t cell = (size_t)s * T + h;
            fwd_type[cell] = (uint8_t)msg(s);
            fwd_line[cell] = eff_line;
            fwd_time[cell] = arrival;
            ++rank;
        }
    }
}
