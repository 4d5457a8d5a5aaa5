"""ATAC optical NoC (`common/network/models/network_model_atac.cc`).

Port of `graphite_tpu/models/network_atac.py`.  The tile mesh is cut
into clusters (2-D sub-meshes); intra-cluster traffic rides an
electrical mesh (ENet, router + link cycles a hop); inter-cluster
traffic (every such unicast under `cluster_based`, those longer than
`unicast_distance_threshold` hops under `distance_based`) goes over the
ENet to the sender cluster's optical hub, through the send hub's
router and queue, over the waveguide (`optical_link_ps`), through the
receive hub's router and queue, and down the receive net to the
destination; receive-side serialization as in every network model.
Hub contention: one queue per send hub and per receive hub, plus a
scratch queue (`scatter_queue_delay`).

`route_atac_plain` is the plain version of the `atac_route` kernel
(`csrc/atac_route.cu`, wrapper `ops/atac_route.py`); it returns a new
state, like the JAX function.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from graphite_tpu_torch.engine.state import _TensorTree
from graphite_tpu_torch.models.network_emesh import mesh_dims
from graphite_tpu_torch.models.queue_models import (
    QueueArrays, QueueParams, make_queues, scatter_queue_delay,
)
from graphite_tpu_torch.time_types import cycles_to_ps, ps_to_cycles

I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class AtacParams:
    n_tiles: int
    mesh_width: int
    mesh_height: int
    cluster_size: int          # tiles per cluster (square sub-mesh)
    cluster_width: int         # sub-mesh dims (cluster_width x cluster_height)
    cluster_height: int
    n_clusters: int
    flit_width_bits: int
    freq_mhz: int
    enet_hop_cycles: int       # enet router + link
    send_hub_cycles: int
    receive_hub_cycles: int
    receive_net_cycles: int    # per receive-net router
    receive_net_levels: int    # 1 for star, log2(cluster_size) for htree
    optical_link_ps: int       # waveguide + E-O + O-E, precomputed
    global_routing_strategy: str   # cluster_based | distance_based
    unicast_distance_threshold: int
    queue: QueueParams
    contention_enabled: bool = True

    @classmethod
    def from_config(cls, sc, network: str = "user") -> "AtacParams":
        from graphite_tpu_torch.models.network_user import (
            _network_domain_freq_mhz,
        )

        cfg = sc.cfg
        sec = "network/atac"
        w, h = mesh_dims(sc.application_tiles)
        cluster_size = cfg.get_int(f"{sec}/cluster_size", 4)
        if sc.application_tiles % cluster_size != 0:
            raise ValueError(
                f"atac cluster_size {cluster_size} does not divide "
                f"{sc.application_tiles} tiles")
        n_clusters = sc.application_tiles // cluster_size
        # clusters are cw x ch sub-meshes, as square as cluster_size
        # allows (`getClusterID`, `network_model_atac.cc:659-674`)
        cw = int(math.isqrt(cluster_size))
        while cluster_size % cw != 0:
            cw -= 1
        ch = cluster_size // cw
        if w % cw != 0 or h % ch != 0:
            raise ValueError(
                f"atac cluster {cw}x{ch} does not tile the {w}x{h} mesh")
        freq_mhz = _network_domain_freq_mhz(
            sc, "NETWORK_USER" if network == "user" else "NETWORK_MEMORY")
        recv_type = cfg.get_string(f"{sec}/receive_network_type", "star")
        levels = (1 if recv_type == "star"
                  else max(1, int(math.log2(cluster_size))))
        # waveguide: tile_width x (w + h) mm (`computeOpticalLinkLength`)
        tile_width_mm = cfg.get_float("general/tile_width", 1.0)
        length_mm = tile_width_mm * (w + h)
        wg_ns_per_mm = cfg.get_float(
            "link_model/optical/waveguide_delay_per_mm", 10e-3)
        eo = cfg.get_int("link_model/optical/E-O_conversion_delay", 1)
        oe = cfg.get_int("link_model/optical/O-E_conversion_delay", 1)
        optical_link_ps = int(
            math.ceil(wg_ns_per_mm * length_mm * 1000)
            + cycles_to_ps(eo + oe, freq_mhz))
        qtype = cfg.get_string(f"{sec}/queue_model/type", "history_tree")
        return cls(
            n_tiles=sc.application_tiles,
            mesh_width=w,
            mesh_height=h,
            cluster_size=cluster_size,
            cluster_width=cw,
            cluster_height=ch,
            n_clusters=n_clusters,
            flit_width_bits=cfg.get_int(f"{sec}/flit_width", 64),
            freq_mhz=freq_mhz,
            enet_hop_cycles=(cfg.get_int(f"{sec}/enet/router/delay", 1)
                             + cfg.get_int(f"{sec}/enet/link/delay", 1)),
            send_hub_cycles=cfg.get_int(
                f"{sec}/onet/send_hub/router/delay", 1),
            receive_hub_cycles=cfg.get_int(
                f"{sec}/onet/receive_hub/router/delay", 1),
            receive_net_cycles=cfg.get_int(
                f"{sec}/star_net/router/delay", 1),
            receive_net_levels=levels,
            optical_link_ps=optical_link_ps,
            global_routing_strategy=cfg.get_string(
                f"{sec}/global_routing_strategy", "cluster_based"),
            unicast_distance_threshold=cfg.get_int(
                f"{sec}/unicast_distance_threshold", 4),
            queue=QueueParams.from_config(cfg, qtype, 1),
            contention_enabled=cfg.get_bool(
                f"{sec}/queue_model/enabled", True),
        )


@dataclasses.dataclass
class AtacState(_TensorTree):
    # [send hubs | receive hubs | scratch]: one queue per cluster hub
    hub_queues: QueueArrays


def init_atac_state(p: AtacParams, device) -> AtacState:
    return AtacState(hub_queues=make_queues(2 * p.n_clusters + 1, p.queue,
                                            device))


def _cluster_of(p: AtacParams, tile):
    """2-D sub-mesh cluster id (`getClusterID`)."""
    x = tile % p.mesh_width
    y = torch.div(tile, p.mesh_width, rounding_mode="floor")
    cx = torch.div(x, p.cluster_width, rounding_mode="floor")
    cy = torch.div(y, p.cluster_height, rounding_mode="floor")
    return cy * (p.mesh_width // p.cluster_width) + cx


def _hub_tile(p: AtacParams, cluster):
    """The tile of the cluster's optical hub: the sub-mesh's top-left
    corner (`getTileIDWithOpticalHub`)."""
    per_row = p.mesh_width // p.cluster_width
    cx = cluster % per_row
    cy = torch.div(cluster, per_row, rounding_mode="floor")
    return cy * p.cluster_height * p.mesh_width + cx * p.cluster_width


def _enet_hops(p: AtacParams, a, b):
    w = p.mesh_width
    return (torch.abs(a % w - b % w)
            + torch.abs(torch.div(a, w, rounding_mode="floor")
                        - torch.div(b, w, rounding_mode="floor"))).to(I64)


def _flits(p: AtacParams, bits):
    # the JAX expression's dtype: `bits` arithmetic, then int64
    return torch.div(bits + p.flit_width_bits - 1, p.flit_width_bits,
                     rounding_mode="floor").to(I64)


def atac_use_onet(p: AtacParams, src, dst):
    """Which (src, dst) pairs ride the ONet (broadcastable bool)."""
    same = _cluster_of(p, src) == _cluster_of(p, dst)
    if p.global_routing_strategy == "distance_based":
        return ~(same | (_enet_hops(p, src, dst)
                         <= p.unicast_distance_threshold))
    return ~same


def route_atac_plain(p: AtacParams, state: AtacState, src, dst, bits,
                     clock_ps, mask, enabled):
    """Route one packet a lane (`route_atac`, `network_atac.py:176-243`);
    returns (new AtacState, arrival_ps, used_onet)."""
    src = src.to(I64)
    dst = dst.to(I64)
    enabled = torch.as_tensor(enabled, device=src.device)
    csrc = _cluster_of(p, src)
    cdst = _cluster_of(p, dst)
    use_onet = mask & atac_use_onet(p, src, dst)
    onet_live = use_onet & enabled

    def cyc(n):
        return cycles_to_ps(n, p.freq_mhz)

    flits = _flits(p, bits)
    ser_ps = torch.where(src == dst, 0, cyc(flits))
    enet_ps = cyc(_enet_hops(p, src, dst) * p.enet_hop_cycles)
    to_hub = _enet_hops(p, src, _hub_tile(p, csrc))
    from_hub = cyc(p.receive_net_levels * p.receive_net_cycles)
    sendhub_arrive = clock_ps + cyc(to_hub * p.enet_hop_cycles)
    scratch = 2 * p.n_clusters
    queues = state.hub_queues
    service = torch.clamp(flits, min=1)
    if p.contention_enabled:
        queues, delay_cyc = scatter_queue_delay(
            p.queue, queues, torch.where(onet_live, csrc, scratch),
            ps_to_cycles(sendhub_arrive, p.freq_mhz), service, onet_live)
        sendhub_done = sendhub_arrive + cyc(delay_cyc + p.send_hub_cycles)
    else:
        sendhub_done = sendhub_arrive + cyc(p.send_hub_cycles)
    recvhub_arrive = sendhub_done + torch.where(enabled, p.optical_link_ps,
                                                0)
    if p.contention_enabled:
        queues, delay2 = scatter_queue_delay(
            p.queue, queues,
            torch.where(onet_live, p.n_clusters + cdst, scratch),
            ps_to_cycles(recvhub_arrive, p.freq_mhz), service, onet_live)
        recvhub_done = recvhub_arrive + cyc(delay2 + p.receive_hub_cycles)
    else:
        recvhub_done = recvhub_arrive + cyc(p.receive_hub_cycles)
    onet_ps = (recvhub_done - clock_ps) + from_hub
    route_ps = torch.where(use_onet, onet_ps, enet_ps)
    total_ps = torch.where(enabled, route_ps + ser_ps, 0)
    arrival = clock_ps + torch.where(mask, total_ps, 0)
    return AtacState(hub_queues=queues), arrival, use_onet


def atac_zeroload_ps(p: AtacParams, src, dst, bits, enabled):
    """Contention-free ATAC latency: what `route_atac_plain` charges on
    idle hubs (`network_atac.py:256-281`); the MEMORY net's zero-load
    basis."""
    def cyc(n):
        return cycles_to_ps(n, p.freq_mhz)

    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    enabled = torch.as_tensor(enabled, device=src.device)
    flits = _flits(p, torch.as_tensor(bits, device=src.device))
    ser_ps = torch.where(src == dst, 0, cyc(flits))
    enet_ps = cyc(_enet_hops(p, src, dst) * p.enet_hop_cycles)
    to_hub = cyc(_enet_hops(p, src, _hub_tile(p, _cluster_of(p, src)))
                 * p.enet_hop_cycles)
    onet_ps = (to_hub + cyc(p.send_hub_cycles)
               + torch.where(enabled, p.optical_link_ps, 0)
               + cyc(p.receive_hub_cycles)
               + cyc(p.receive_net_levels * p.receive_net_cycles))
    total = torch.where(atac_use_onet(p, src, dst), onet_ps, enet_ps) + ser_ps
    return torch.where(enabled, total, 0)
