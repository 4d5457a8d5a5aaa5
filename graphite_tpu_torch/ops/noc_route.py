"""`noc_route`: the USER net's sends through the emesh_hop_by_hop NoC.

Replaces `route_hop_by_hop` (`graphite_tpu/models/network_hop_by_hop.py:
123-185`) with `_dense_contention` (`:188-377`), as the JAX step's
`_net_block` calls it (`graphite_tpu/engine/step.py:415-423`): every
lane t that is active at a SEND routes one packet t -> clip(aux0) of
(64 + aux1) * 8 bits, sent at its clock, when models are enabled.
Writes `lanes.route_lat_ps` = arrival - clock (0 for the other lanes),
which `user_mailbox` then stores, and commits the port queues of
`nst` in place.  Kernel: `csrc/noc_route.cu` (one cooperative launch:
a thread a packet, reductions into per-port accumulators, a grid
barrier, then a thread a port row); plain version:
`route_hop_by_hop_plain`, the JAX package's dense formulation.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.models.network_hop_by_hop import (
    NUM_PORTS, HopByHopParams, NocState, route_hop_by_hop_plain,
)
from graphite_tpu_torch.models.network_user import user_packet_bits
from graphite_tpu_torch.models.queue_models import N_COLS
from graphite_tpu_torch.ops.build import Kernel, pack_args
from graphite_tpu_torch.trace.schema import Op

# per (cell, port) accumulators of one call (`NocArgs.scratch`)
N_ACC = 9
_SCRATCH: dict = {}


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`NocArgs` in
    csrc/noc_route.cu: the pointers, then the mesh, the delays and the
    queue model)."""
    (p,) = key
    T = tensors[0].shape[0]
    R = p.mesh_width * p.mesh_height * NUM_PORTS
    if R > T * NUM_PORTS:
        raise ValueError(f"noc_route: {T} tiles do not fill the "
                         f"{p.mesh_width}x{p.mesh_height} mesh")
    i64, i32, b = torch.int64, torch.int32, torch.bool
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.aux0", i32, t),
             ("lanes.aux1", i32, t), ("lanes.active", b, t),
             ("clock_ps", i64, t), ("enabled", b, ()),
             ("queues.data", i64, (T * NUM_PORTS + 1, N_COLS)),
             ("scratch", i64, (R + 1, N_ACC)),
             ("lanes.route_lat_ps", i64, t)]
    return pack_args(tensors, specs, (
        T, p.mesh_width, p.mesh_height, p.router_delay, p.link_delay,
        p.flit_width_bits, p.freq_mhz, int(p.queue.history),
        int(p.queue.analytical_enabled), p.queue.history_span,
        int(p.contention_enabled)))


KERNEL = Kernel("noc_route", "gt_noc_route", pack=_pack)


def _lane_packets(lanes: Lanes, clock: torch.Tensor):
    """(src, dst, bits, send_now) of the step's net unit."""
    T = clock.shape[0]
    src = torch.arange(T, dtype=torch.int32, device=clock.device)
    dst = torch.clamp(lanes.aux0, 0, T - 1)
    send_now = lanes.active & (lanes.op == Op.SEND)
    return src, dst, user_packet_bits(lanes.aux1), send_now


def noc_route_plain(p: HopByHopParams, nst: NocState, lanes: Lanes,
                    clock: torch.Tensor, enabled: torch.Tensor) -> None:
    src, dst, bits, send_now = _lane_packets(lanes, clock)
    new, arrival, _, _ = route_hop_by_hop_plain(p, nst, src, dst, bits,
                                                clock, send_now, enabled)
    nst.queues.data.copy_(new.queues.data)
    lanes.route_lat_ps.copy_(arrival - clock)


def noc_route(p: HopByHopParams, nst: NocState, lanes: Lanes,
              clock: torch.Tensor, enabled: torch.Tensor) -> None:
    """Route this iteration's sends; writes `lanes.route_lat_ps` and
    updates `nst`'s port queues in place."""
    if clock.device.type == "cpu":
        noc_route_plain(p, nst, lanes, clock, enabled)
        return
    if clock.device.type != "cuda":
        raise ValueError(f"noc_route: unsupported device {clock.device}")
    KERNEL.launch_bound(*bound_args(p, nst, lanes, clock, enabled))


def scratch_for(p: HopByHopParams, device) -> torch.Tensor:
    """The call's per-port accumulators, then the grid barrier's two
    words: zero between calls (the kernel clears what it used), one
    tensor per device and mesh."""
    key = (device, p.mesh_width, p.mesh_height)
    s = _SCRATCH.get(key)
    if s is None:
        s = torch.zeros((p.mesh_width * p.mesh_height * NUM_PORTS + 1,
                         N_ACC), dtype=torch.int64, device=device)
        _SCRATCH[key] = s
    return s


def bound_args(p: HopByHopParams, nst: NocState, lanes: Lanes,
               clock: torch.Tensor, enabled: torch.Tensor) -> tuple:
    """The (tensors, key) a call binds, in `NocArgs` order."""
    return ((lanes.op, lanes.aux0, lanes.aux1, lanes.active, clock,
             enabled, nst.queues.data, scratch_for(p, clock.device),
             lanes.route_lat_ps), (p,))
