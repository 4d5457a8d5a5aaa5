"""`mem_net_route`: a set of coherence messages through the MEMORY net's
contention model, and the MEMORY net's part of every memory kernel's
argument block.

Replaces `mem_net_send` (`graphite_tpu/memory/engine.py:251-277`) where
the engine's plain phases call it: phase 4's acks (`:1975`) and phase
5's replies (`:2175`), under `[network] memory = emesh_hop_by_hop`
(`route_hop_by_hop`) or `memory = atac` (`route_atac`).  Kernel:
`csrc/mem_net_route.cu`, one CTA, a thread a packet, which captures into
the phases' CUDA graphs as a plain launch; plain version:
`memory/net.py` `mem_net_send`.  Each packet i (src, dst, bits, t0,
mask) gets its arrival in ps, and the queues of `noc` are committed in
place.

The three memory kernels route their own message sets with the same
device code (`csrc/net_route.cuh`): `net_kind` selects their
instantiation, and `pack_with_net` appends the `NetConsts` tail of their
argument blocks (`net_tensors`, `net_values`).
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory.net import commit, mem_net_send
from graphite_tpu_torch.memory.params import MemParams
from graphite_tpu_torch.models.network_hop_by_hop import NUM_PORTS
from graphite_tpu_torch.models.queue_models import N_COLS
from graphite_tpu_torch.ops.build import Kernel, check_width, pack_args
from graphite_tpu_torch.ops.noc_route import N_ACC
from graphite_tpu_torch.time_types import cycles_to_ps

MAX_PACKETS = 1024     # one CTA, a thread a packet
# MemConsts.net_kind: the zero-load nets, then the contention nets (the
# kernels' NET_HBH / NET_ATAC instantiations)
NET_KINDS = {"magic": 0, "emesh_hop_counter": 1, "emesh_hop_by_hop": 2,
             "atac": 3}
_SCRATCH: dict = {}


def net_kind(mp: MemParams) -> int:
    if mp.net_hbh is not None:
        return NET_KINDS["emesh_hop_by_hop"]
    if mp.net_atac is not None:
        return NET_KINDS["atac"]
    return NET_KINDS[mp.net_kind]


def scratch_for(mp: MemParams, device) -> "torch.Tensor | None":
    """The MEMORY net's per-port accumulators under emesh_hop_by_hop
    (zero between routes: each route clears what it used), one tensor
    per device and mesh, apart from the USER net's (`ops/noc_route.py`);
    None under the other nets."""
    p = mp.net_hbh
    if p is None:
        return None
    key = (device, p.mesh_width, p.mesh_height)
    s = _SCRATCH.get(key)
    if s is None:
        s = torch.zeros((p.mesh_width * p.mesh_height * NUM_PORTS, N_ACC),
                        dtype=torch.int64, device=device)
        _SCRATCH[key] = s
    return s


def net_tensors(mp: MemParams, noc) -> tuple:
    """(queue rows, scratch): the pointers of `NetConsts`."""
    if mp.net_hbh is not None:
        return noc.queues.data, scratch_for(mp, noc.queues.data.device)
    if mp.net_atac is not None:
        return noc.hub_queues.data, None
    return None, None


def net_values(hbh, atac) -> tuple:
    """The plain values of `NetConsts` (csrc/net_route.cuh) for
    `MemParams.net_hbh` / `net_atac`: the queue model, the hop-by-hop
    mesh, the ATAC clusters and delays (zeros for a zero-load net)."""
    p = hbh if hbh is not None else atac
    if p is None:
        return (0,) * 20
    q = p.queue
    head = (p.freq_mhz, p.flit_width_bits, int(q.history),
            int(q.analytical_enabled), q.history_span,
            int(p.contention_enabled))
    if hbh is not None:
        return head + (p.mesh_width, p.mesh_height, p.router_delay,
                       p.link_delay) + (0,) * 10
    return head + (p.mesh_width, p.mesh_height, 0, 0, p.n_clusters,
                   p.cluster_width, p.cluster_height, p.enet_hop_cycles,
                   p.send_hub_cycles, p.receive_hub_cycles,
                   cycles_to_ps(p.receive_net_levels * p.receive_net_cycles,
                                p.freq_mhz),
                   p.optical_link_ps,
                   int(p.global_routing_strategy == "distance_based"),
                   p.unicast_distance_threshold)


def net_specs(hbh, atac, T: int) -> list:
    i64 = torch.int64
    if hbh is not None:
        return [("noc.queues.data", i64, (T * NUM_PORTS + 1, N_COLS)),
                ("net_scratch", i64,
                 (hbh.mesh_width * hbh.mesh_height * NUM_PORTS, N_ACC))]
    rows = 2 * atac.n_clusters + 1 if atac is not None else 0
    return [("noc.hub_queues.data", i64, (rows, N_COLS)),
            ("net_scratch", i64, (0,))]


def pack_with_net(tensors: tuple, specs, values, hbh, atac, T: int):
    """`pack_args` of a memory kernel whose last two tensors are
    `net_tensors`: the other pointers, `values`, then `NetConsts` (the two
    net pointers and the net's values; `hbh`, `atac`: `MemParams.net_hbh`
    and `net_atac`)."""
    main = pack_args(tensors[:-2], specs, values)
    net = pack_args(tensors[-2:], net_specs(hbh, atac, T),
                    net_values(hbh, atac))
    return (type(main)._type_ * (len(main) + len(net)))(*main, *net)


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`RouteArgs` in
    csrc/mem_net_route.cu); `key` = (net_hbh, net_atac, T)."""
    hbh, atac, T = key
    check_width("mem_net_route", T, MAX_PACKETS, "packets")
    i64 = torch.int64
    t = (T,)
    specs = [("src", i64, t), ("dst", i64, t), ("bits", i64, t),
             ("t0", i64, t), ("mask", torch.bool, t),
             ("enabled", torch.bool, ()), ("arrival", i64, t)]
    kind = 1 if hbh is not None else 2       # NET_HBH, NET_ATAC
    return pack_with_net(tensors, specs, (T, kind), hbh, atac, T)


KERNEL = Kernel("mem_net_route", "gt_mem_net_route", pack=_pack)


def mem_net_route_plain(mp: MemParams, noc, src, dst, bits, t0, mask,
                        enabled) -> torch.Tensor:
    new, arrival = mem_net_send(mp, noc, src, dst, bits, t0, mask, enabled)
    commit(noc, new)
    return arrival


def mem_net_route(mp: MemParams, noc, src, dst, bits, t0, mask,
                  enabled) -> torch.Tensor:
    """The arrivals (int64[T], ps) of one message a tile through the
    MEMORY net's contention model; commits `noc`'s queues in place."""
    dev = t0.device
    if dev.type == "cpu":
        return mem_net_route_plain(mp, noc, src, dst, bits, t0, mask,
                                   enabled)
    if dev.type != "cuda":
        raise ValueError(f"mem_net_route: unsupported device {dev}")
    out = torch.empty_like(t0, dtype=torch.int64)
    KERNEL.launch_bound(*bound_args(mp, noc, src, dst, bits, t0, mask,
                                    enabled, out))
    return out


def bound_args(mp: MemParams, noc, src, dst, bits, t0, mask, enabled,
               out) -> tuple:
    """The (tensors, key) a call binds, in `RouteArgs` order."""
    i64 = torch.int64
    T = t0.shape[0]
    # a fill, not a host copy: the call may be captured in a CUDA graph
    bits = (bits.to(i64).contiguous() if isinstance(bits, torch.Tensor)
            else torch.full((T,), bits, dtype=i64, device=t0.device))
    return ((src.to(i64).contiguous(), dst.to(i64).contiguous(), bits,
             t0.to(i64).contiguous(), mask.contiguous(),
             enabled, out, *net_tensors(mp, noc)),
            (mp.net_hbh, mp.net_atac, mp.n_tiles))
