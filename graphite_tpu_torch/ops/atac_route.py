"""`atac_route`: the USER net's sends through the ATAC optical NoC.

Replaces `route_atac` (`graphite_tpu/models/network_atac.py:176-243`)
with its two `scatter_queue_delay` calls (`graphite_tpu/models/
queue_models.py:277-346`), as the JAX step's `_net_block` calls it
(`graphite_tpu/engine/step.py:424-431`): every lane t active at a SEND
routes one packet t -> clip(aux0) of (64 + aux1) * 8 bits at its clock.
Writes `lanes.route_lat_ps` = arrival - clock (0 for the other lanes)
and commits the hub queues in place: the send hubs against the
pre-call state, fully, then the receive hubs against the committed
state.  Kernel: `csrc/atac_route.cu` (one CTA, one thread a lane, the
hub queues in shared memory); plain version: `route_atac_plain`.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.models.network_atac import (
    AtacParams, AtacState, route_atac_plain,
)
from graphite_tpu_torch.models.queue_models import N_COLS
from graphite_tpu_torch.ops.build import Kernel, check_width, pack_args
from graphite_tpu_torch.ops.noc_route import _lane_packets
from graphite_tpu_torch.time_types import cycles_to_ps

MAX_LANES = 1024     # one CTA, one thread a lane


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`AtacArgs` in
    csrc/atac_route.cu)."""
    (p,) = key
    T = tensors[0].shape[0]
    check_width("atac_route", T, MAX_LANES, "lanes")
    i64, i32, b = torch.int64, torch.int32, torch.bool
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.aux0", i32, t),
             ("lanes.aux1", i32, t), ("lanes.active", b, t),
             ("clock_ps", i64, t), ("enabled", b, ()),
             ("hub_queues.data", i64, (2 * p.n_clusters + 1, N_COLS)),
             ("lanes.route_lat_ps", i64, t)]
    return pack_args(tensors, specs, (
        T, p.n_clusters, p.mesh_width, p.cluster_width, p.cluster_height,
        p.flit_width_bits, p.freq_mhz, p.enet_hop_cycles, p.send_hub_cycles,
        p.receive_hub_cycles,
        cycles_to_ps(p.receive_net_levels * p.receive_net_cycles,
                     p.freq_mhz),
        p.optical_link_ps, int(p.global_routing_strategy == "distance_based"),
        p.unicast_distance_threshold, int(p.queue.history),
        int(p.queue.analytical_enabled), p.queue.history_span,
        int(p.contention_enabled)))


KERNEL = Kernel("atac_route", "gt_atac_route", pack=_pack)


def atac_route_plain(p: AtacParams, st: AtacState, lanes: Lanes,
                     clock: torch.Tensor, enabled: torch.Tensor) -> None:
    src, dst, bits, send_now = _lane_packets(lanes, clock)
    new, arrival, _ = route_atac_plain(p, st, src, dst, bits, clock,
                                       send_now, enabled)
    st.hub_queues.data.copy_(new.hub_queues.data)
    lanes.route_lat_ps.copy_(arrival - clock)


def atac_route(p: AtacParams, st: AtacState, lanes: Lanes,
               clock: torch.Tensor, enabled: torch.Tensor) -> None:
    """Route this iteration's sends; writes `lanes.route_lat_ps` and
    updates the hub queues in place."""
    if clock.device.type == "cpu":
        atac_route_plain(p, st, lanes, clock, enabled)
        return
    if clock.device.type != "cuda":
        raise ValueError(f"atac_route: unsupported device {clock.device}")
    KERNEL.launch_bound(*bound_args(p, st, lanes, clock, enabled))


def bound_args(p: AtacParams, st: AtacState, lanes: Lanes,
               clock: torch.Tensor, enabled: torch.Tensor) -> tuple:
    """The (tensors, key) a call binds, in `AtacArgs` order."""
    return ((lanes.op, lanes.aux0, lanes.aux1, lanes.active, clock,
             enabled, st.hub_queues.data, lanes.route_lat_ps), (p,))
