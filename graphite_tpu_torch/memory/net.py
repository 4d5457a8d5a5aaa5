"""The MEMORY network: coherence messages through the configured model.

Port of `graphite_tpu/memory/engine.py` `mem_net_send` (:251-277) and
`mem_net_fanout` (:280-374).  Under `[network] memory = emesh_hop_by_hop`
(`MemParams.net_hbh`) a message routes through the dense per-hop
contention engine on the MEMORY NoC's own port queues (`MemState.noc`,
a `NocState`); under `memory = atac` (`MemParams.net_atac`) over the
clusters, hubs and waveguide with hub contention (an `AtacState`);
otherwise it takes the zero-load hop-counter or magic latency and no
state.  The reference routes every ShmemMsg through the memory net's
model (`carbon_sim.cfg:281-282`).

`mem_net_send` and `mem_net_fanout` are the plain versions, pure like
the JAX functions (they return a new state).  The multicast charges the
dominant contention exactly and approximates the rest, as the JAX
package and its golden oracle do: under hop-by-hop one queue charge of
k * flits on the home's INJECT port, each copy its rank among the
targets (by tile id) times its flits, then the zero-load path; under
ATAC one charge of k_onet * flits on the home cluster's send hub, its
delay on the ONet copies only.

`send` and `fanout` are the engine's in-place forms (`MemCtx`, a
`MemState`): the zero-load nets keep the latency table of `MemCtx`, the
contention nets commit `ms.noc` in place.  On a CUDA device `send` with
`plain=False` routes through the `mem_net_route` kernel (phases 4 and 5
inside their CUDA graphs); the plain kernels' phases pass `plain=True`.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory.common import mem_net_latency_ps
from graphite_tpu_torch.memory.params import MemParams
from graphite_tpu_torch.models import queue_models as qm
from graphite_tpu_torch.models.network_atac import (
    AtacState, _cluster_of, atac_use_onet, atac_zeroload_ps,
    route_atac_plain,
)
from graphite_tpu_torch.models.network_hop_by_hop import (
    NUM_PORTS, PORT_INJECT, NocState, route_hop_by_hop_plain,
)
from graphite_tpu_torch.time_types import cycles_to_ps, ps_to_cycles

I64 = torch.int64


def _bits(bits, like: torch.Tensor) -> torch.Tensor:
    if isinstance(bits, torch.Tensor):
        return bits.to(I64).expand(like.shape)
    return torch.full(like.shape, bits, dtype=I64, device=like.device)


def mem_net_send(mp: MemParams, noc, src, dst, bits, t0_ps, mask, enabled):
    """Unicast one coherence message a lane: (noc, arrival_ps[L])."""
    enabled = torch.as_tensor(enabled, device=t0_ps.device)
    if mp.net_atac is not None:
        noc, arrival, _ = route_atac_plain(
            mp.net_atac, noc, src, dst, _bits(bits, t0_ps), t0_ps, mask,
            enabled)
        return noc, arrival
    if mp.net_hbh is None:
        return noc, t0_ps + mem_net_latency_ps(mp, src, dst, bits, enabled)
    noc, arrival, _, _ = route_hop_by_hop_plain(
        mp.net_hbh, noc, src, dst, _bits(bits, t0_ps), t0_ps, mask, enabled)
    return noc, arrival


def mem_net_fanout(mp: MemParams, noc, send_hs, bits: int, t0_ps, enabled):
    """A home's INV / FLUSH / WB multicast: `send_hs` bool[T(home),
    T(target)], `t0_ps` int64[T(home)]; returns (noc, arrival_ps[T, T])."""
    T = mp.n_tiles
    dev = send_hs.device
    en = torch.as_tensor(enabled, device=dev)
    src = torch.arange(T, dtype=I64, device=dev)[:, None]
    dst = torch.arange(T, dtype=I64, device=dev)[None, :]
    rank = torch.cumsum(send_hs.to(I64), dim=1) - 1
    fan = send_hs.any(dim=1)
    if mp.net_atac is not None:
        p = mp.net_atac
        zl = atac_zeroload_ps(p, src, dst, bits, en)             # [T, T]
        flits = max(1, (bits + p.flit_width_bits - 1) // p.flit_width_bits)
        onet_pair = atac_use_onet(p, src, dst)                   # [T, T]
        k_onet = (send_hs & onet_pair).sum(dim=1, dtype=I64)
        if p.contention_enabled:
            go = fan & (k_onet > 0) & en
            home = torch.arange(T, dtype=I64, device=dev)
            qid = torch.where(go, _cluster_of(p, home), 2 * p.n_clusters)
            queues, hub_delay = qm.scatter_queue_delay(
                p.queue, noc.hub_queues, qid,
                ps_to_cycles(t0_ps, p.freq_mhz), k_onet * flits, go)
            noc = AtacState(hub_queues=queues)
        else:
            hub_delay = torch.zeros(T, dtype=I64, device=dev)
        extra = rank * flits + torch.where(onet_pair, hub_delay[:, None], 0)
        extra = torch.where(en, extra, 0)
        return noc, t0_ps[:, None] + zl + cycles_to_ps(extra, p.freq_mhz)
    if mp.net_hbh is None:
        lat = mem_net_latency_ps(mp, src, dst, bits, en)
        return noc, t0_ps[:, None] + lat
    p = mp.net_hbh
    w = p.mesh_width
    flits = max(1, (bits + p.flit_width_bits - 1) // p.flit_width_bits)
    hops = (torch.abs(src % w - dst % w)
            + torch.abs(torch.div(src, w, rounding_mode="floor")
                        - torch.div(dst, w, rounding_mode="floor")))
    step = p.router_delay + p.link_delay
    zl = p.router_delay + (hops + 1) * step + torch.where(src == dst, 0,
                                                          flits)
    k = send_hs.sum(dim=1, dtype=I64)
    if p.contention_enabled:
        qid = torch.arange(T, dtype=I64, device=dev) * NUM_PORTS + PORT_INJECT
        queues, inj_delay = qm.scatter_queue_delay(
            p.queue, noc.queues, qid, ps_to_cycles(t0_ps, p.freq_mhz),
            k * flits, fan & en)
        noc = NocState(queues=queues)
    else:
        inj_delay = torch.zeros(T, dtype=I64, device=dev)
    cyc = torch.where(en, zl + inj_delay[:, None] + rank * flits, 0)
    return noc, t0_ps[:, None] + cycles_to_ps(cyc, p.freq_mhz)


def commit(noc, new) -> None:
    """Copy a route's new queue rows into `noc` in place (the state's
    tensors are bound by the kernels and the CUDA graphs)."""
    if isinstance(noc, NocState):
        noc.queues.data.copy_(new.queues.data)
    else:
        noc.hub_queues.data.copy_(new.hub_queues.data)


def send(ctx, ms, src, dst, rep, t0, mask, enabled, *,
         plain: bool = False) -> torch.Tensor:
    """The arrival of one message a lane src -> dst sent at t0 (`rep`: a
    bool, or a bool tensor a lane, for line-carrying messages), 0 latency
    while models are off; the contention nets commit `ms.noc` in place
    (masked lanes route nothing)."""
    mp = ctx.mp
    if ms.noc is None:
        return t0 + ctx.net_ps(src, dst, enabled, rep=rep)
    bits = (torch.where(rep, mp.rep_bits, mp.req_bits)
            if isinstance(rep, torch.Tensor)
            else (mp.rep_bits if rep else mp.req_bits))
    if plain:
        new, arrival = mem_net_send(mp, ms.noc, src, dst, bits, t0, mask,
                                    enabled)
        commit(ms.noc, new)
        return arrival
    from graphite_tpu_torch.ops.mem_net_route import mem_net_route

    return mem_net_route(mp, ms.noc, src, dst, bits, t0, mask, enabled)


def fanout(ctx, ms, send_hs, t0, enabled) -> torch.Tensor:
    """The arrivals [home, target] of the homes' INV / FLUSH / WB copies
    (header-only messages) sent at t0[home]; commits `ms.noc`."""
    mp = ctx.mp
    if ms.noc is None:
        return t0[:, None] + torch.where(enabled, ctx.lat[False], 0)
    new, arrival = mem_net_fanout(mp, ms.noc, send_hs, mp.req_bits, t0,
                                  enabled)
    commit(ms.noc, new)
    return arrival
