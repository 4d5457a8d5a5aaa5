"""`user_mailbox`: USER-network send and receive over the mailbox rings.

Replaces `_net_block` (`graphite_tpu/engine/step.py:413-502`) with the
emesh_hop_counter / magic `route_latency_ps`
(`graphite_tpu/models/network_user.py:96-116`), or, under a contention
net (emesh_hop_by_hop, atac: network kind "routed"), with each lane's
latency as `noc_route` / `atac_route` routed it (`lanes.route_lat_ps`;
the kernel's KIND_ROUTED instantiation).  Kernel:
`csrc/user_mailbox.cu`, one launch per call: each send is applied by
exactly one thread — the receiver's, when its receive reads the cell the
send writes, else the sender's — so every receive matches against the
POST-send arrays (`step.py:454-457`) with no grid-wide barrier and no
atomics.  The wrapper launches through a binding
(`build.Kernel.launch_bound`): its arguments are validated once per set
of tensors, not on every call.

Semantics (both versions, updating the rings in place):
 - send (lane t, active SEND to dst = clip(aux0)): slot = head[dst, t]
   mod D; time_ps[dst, slot, t] = clock + latency; lat_ps[...] = latency
   wrapped to int32; head[dst, t] += 1; count[dst, t] += 1; overflow |=
   count[dst, t] > D.  Each sender owns its src column: no collisions.
 - receive (lane t at NET_RECV): the named sender clip(aux0), or for an
   ACTIVE ANY_SENDER (aux0 == -1) lane the source whose oldest entry
   arrives first (first index on ties, like `jnp.argmin`; sender 0 when
   the lane is not active); matched = count[t, src] > 0; recv_time = that
   entry's arrival (FAR when unmatched), recv_lat its latency; an active
   matched lane pops it (count[t, src] -= 1).
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.state import FAR_FUTURE_PS, Lanes, UserNetState
from graphite_tpu_torch.models.network_user import (
    UserNetworkParams, route_latency_ps,
)
from graphite_tpu_torch.ops.build import Kernel, pack_args
from graphite_tpu_torch.trace.schema import Op

ANY_SENDER = -1
KIND_MAGIC, KIND_EMESH, KIND_ROUTED = 0, 1, 2
_KINDS = {"magic": KIND_MAGIC, "emesh_hop_counter": KIND_EMESH,
          "routed": KIND_ROUTED}

_ARGS = ("op", "aux0", "aux1", "active", "clock_ps", "time_ps", "lat_ps",
         "head", "count", "overflow", "recv_now", "recv_time", "recv_lat",
         "enabled", "route_lat_ps")


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`MailboxArgs` in
    csrc/user_mailbox.cu: the 15 pointers — the routed latency null
    unless routed — then T, D and the network)."""
    (net_params,) = key
    kind = _KINDS.get(net_params.kind)
    if kind is None:
        raise NotImplementedError(f"user_mailbox: network {net_params.kind}")
    T, D, _ = tensors[5].shape
    i32, i64, b = torch.int32, torch.int64, torch.bool
    shapes = ((i32, (T,)), (i32, (T,)), (i32, (T,)), (b, (T,)), (i64, (T,)),
              (i64, (T, D, T)), (i32, (T, D, T)), (i32, (T, T)),
              (i32, (T, T)), (b, ()), (b, (T,)), (i64, (T,)), (i32, (T,)),
              (b, ()), (i64, (T,)))
    return pack_args(tensors, [(n, *s) for n, s in zip(_ARGS, shapes)], (
        T, D, kind, net_params.freq_mhz,
        net_params.mesh_width, net_params.hop_latency_cycles,
        net_params.flit_width_bits))


KERNEL = Kernel("user_mailbox", "gt_user_mailbox", pack=_pack)


def user_mailbox_plain(net_params: UserNetworkParams, lanes: Lanes,
                       clock: torch.Tensor, enabled: torch.Tensor,
                       net: UserNetState) -> None:
    T, D, _ = net.time_ps.shape
    dev = clock.device
    tiles = torch.arange(T, dtype=torch.int64, device=dev)
    op, aux0, active = lanes.op, lanes.aux0, lanes.active

    # --- send phase -------------------------------------------------------
    send_now = active & (op == Op.SEND)
    dst = torch.clamp(aux0, 0, T - 1)
    lat = (lanes.route_lat_ps if net_params.kind == "routed" else
           route_latency_ps(net_params, tiles.to(torch.int32), dst,
                            lanes.aux1, enabled))
    s = send_now
    sd, st = dst[s].to(torch.int64), tiles[s]
    slot = torch.fmod(net.head[sd, st], D).to(torch.int64)
    net.time_ps[sd, slot, st] = clock[s] + lat[s]
    net.lat_ps[sd, slot, st] = lat[s].to(torch.int32)
    net.head[sd, st] += 1
    net.count[sd, st] += 1
    net.overflow |= torch.any(net.count[sd, st] > D)

    # --- receive phase (reads the post-send rings) -----------------------
    is_recv = op == Op.NET_RECV
    any_live = is_recv & (aux0 == ANY_SENDER) & active
    tail = torch.fmod(net.head - net.count, D).to(torch.int64)   # [T, T]
    tail_times = torch.gather(net.time_ps, 1, tail[:, None, :])[:, 0, :]
    masked = torch.where(net.count > 0, tail_times, FAR_FUTURE_PS)
    any_src = torch.argmin(masked, dim=1)
    want = torch.where(aux0 == ANY_SENDER,
                       torch.where(any_live, any_src, 0),
                       torch.clamp(aux0, 0, T - 1).to(torch.int64))
    sel_count = net.count[tiles, want]
    sel_tail = torch.fmod(net.head[tiles, want] - sel_count,
                          D).to(torch.int64)
    matched = sel_count > 0
    lanes.recv_time.copy_(torch.where(
        matched, net.time_ps[tiles, sel_tail, want], FAR_FUTURE_PS))
    lanes.recv_lat.copy_(net.lat_ps[tiles, sel_tail, want])
    recv_now = active & is_recv & matched
    lanes.recv_now.copy_(recv_now)
    net.count[tiles[recv_now], want[recv_now]] -= 1


def user_mailbox(net_params: UserNetworkParams, lanes: Lanes,
                 clock: torch.Tensor, enabled: torch.Tensor,
                 net: UserNetState) -> None:
    """One iteration's sends and receives; updates `net`'s rings in place
    and writes `lanes.recv_now / recv_time / recv_lat`."""
    if clock.device.type == "cpu":
        user_mailbox_plain(net_params, lanes, clock, enabled, net)
        return
    if clock.device.type != "cuda":
        raise ValueError(f"user_mailbox: unsupported device {clock.device}")
    KERNEL.launch_bound(*bound_args(net_params, lanes, clock, enabled,
                                    net))


def bound_args(net_params: UserNetworkParams, lanes: Lanes,
               clock: torch.Tensor, enabled: torch.Tensor,
               net: UserNetState) -> tuple:
    """The (tensors, key) a call binds, in `MailboxArgs` order."""
    return ((lanes.op, lanes.aux0, lanes.aux1, lanes.active, clock,
             net.time_ps, net.lat_ps, net.head, net.count, net.overflow,
             lanes.recv_now, lanes.recv_time, lanes.recv_lat, enabled,
             lanes.route_lat_ps if net_params.kind == "routed" else None),
            (net_params,))
