"""USER-network latency: magic and emesh_hop_counter (zero-load).

Port of `graphite_tpu/models/network_user.py`.  Reference semantics:
 - magic (`network_model_magic.cc:15-22`): every packet takes exactly one
   network-clock cycle, whatever the model-enable state;
 - emesh_hop_counter (`network_model_emesh_hop_counter.cc:142-157`):
   manhattan_hops * (router + link delay) cycles, plus ceil(packet_bits /
   flit_width) cycles of receive-side serialization unless sender ==
   receiver (`network_model.cc:119-149`), all zero while models are
   disabled; packet_bits = (64-byte NetPacket header + payload) * 8.

`route_latency_ps` is the plain tensor form; the `user_mailbox` CUDA
kernel computes the same expression per lane (`csrc/user_mailbox.cu`).
The contention nets, emesh_hop_by_hop and atac, route in
`models/network_hop_by_hop.py` and `models/network_atac.py`; the mailbox
then takes each lane's routed latency.
"""

from __future__ import annotations

import dataclasses

import torch

from graphite_tpu_torch.config.simconfig import SimConfig
from graphite_tpu_torch.models.network_emesh import mesh_dims
from graphite_tpu_torch.time_types import cycles_to_ps

NET_PACKET_HEADER_BYTES = 64  # sizeof(NetPacket), `network.h:27-53`


@dataclasses.dataclass(frozen=True)
class UserNetworkParams:
    # "magic" | "emesh_hop_counter" | "atac" (a placeholder); "routed" is
    # the mailbox's network under a contention net: each send's latency
    # is the one `noc_route` / `atac_route` wrote (engine/step.py)
    kind: str
    freq_mhz: int             # NETWORK_USER domain frequency
    mesh_width: int = 0
    hop_latency_cycles: int = 2   # router.delay + link.delay
    flit_width_bits: int = -1     # -1 => no serialization (magic)

    @classmethod
    def from_config(cls, cfg: SimConfig) -> "UserNetworkParams":
        kind = cfg.network_types[0]
        freq_mhz = _network_domain_freq_mhz(cfg)
        if kind == "magic":
            return cls(kind="magic", freq_mhz=freq_mhz)
        if kind == "atac":
            # routing and timing live in AtacParams (models/network_atac);
            # this placeholder carries the domain frequency
            return cls(kind="atac", freq_mhz=freq_mhz)
        if kind in ("emesh_hop_counter", "emesh_hop_by_hop"):
            # the zero-load (hop-counter) basis; under emesh_hop_by_hop the
            # contention engine (HopByHopParams, EngineParams.user_hbh)
            # carries the timing the USER net charges
            section = f"network/{kind}"
            router = cfg.cfg.get_int(f"{section}/router/delay", 1)
            link = cfg.cfg.get_int(f"{section}/link/delay", 1)
            flit = cfg.cfg.get_int(f"{section}/flit_width", 64)
            w, _ = mesh_dims(cfg.application_tiles)
            return cls(kind="emesh_hop_counter", freq_mhz=freq_mhz,
                       mesh_width=w, hop_latency_cycles=router + link,
                       flit_width_bits=flit)
        raise ValueError(f"unsupported user network model: {kind}")


def _network_domain_freq_mhz(cfg: SimConfig,
                             module: str = "NETWORK_USER") -> int:
    """DVFS domain frequency of a network module (`carbon_sim.cfg:147-151`)."""
    from graphite_tpu_torch.models.dvfs import parse_dvfs_domains

    for freq_mhz, modules in parse_dvfs_domains(cfg.cfg):
        if module in modules:
            return freq_mhz
    return 1000


def user_packet_bits(payload_bytes):
    return (NET_PACKET_HEADER_BYTES + payload_bytes) * 8


def num_flits(length_bits, flit_width_bits: int):
    """`network_model.cc:203-211`: ceil, or 0 when flit_width <= 0.  The
    division floors, like the JAX package's `//`."""
    if flit_width_bits <= 0:
        return torch.zeros_like(length_bits)
    return torch.div(length_bits + flit_width_bits - 1, flit_width_bits,
                     rounding_mode="floor")


def route_latency_ps(params: UserNetworkParams, src: torch.Tensor,
                     dst: torch.Tensor, payload_bytes: torch.Tensor,
                     enabled: torch.Tensor) -> torch.Tensor:
    """Zero-load arrival delay in int64 ps, elementwise over int32 lanes
    (`src`, `dst`, `payload_bytes` int32; `enabled` a bool scalar)."""
    if params.kind == "magic":
        cycles = torch.ones(src.shape, dtype=torch.int64, device=src.device)
        return cycles_to_ps(cycles, params.freq_mhz)
    w = params.mesh_width
    hops = (torch.abs(src % w - dst % w)
            + torch.abs(torch.div(src, w, rounding_mode="floor")
                        - torch.div(dst, w, rounding_mode="floor")))
    route_cycles = hops.to(torch.int64) * params.hop_latency_cycles
    # int32 arithmetic, like the JAX package's int32 payload column
    ser_cycles = num_flits(user_packet_bits(payload_bytes),
                           params.flit_width_bits).to(torch.int64)
    ser_cycles = torch.where(src == dst, 0, ser_cycles)
    cycles = torch.where(enabled, route_cycles + ser_cycles, 0)
    return cycles_to_ps(cycles, params.freq_mhz)
