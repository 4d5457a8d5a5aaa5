"""emesh_hop_by_hop: the 2D-mesh NoC with per-port router contention.

Port of `graphite_tpu/models/network_hop_by_hop.py` (reference:
`common/network/models/network_model_emesh_hop_by_hop.cc:146-265`,
`components/router/router_model.cc:52-108`): an injection router at the
sender, XY routing (x first, then y) with router + link delay and the
output port's queue delay at every hop, delivery through the
destination's SELF port, then num_flits cycles of receive-side
serialization (none for a self-send).

`route_hop_by_hop_plain` is the JAX package's DENSE formulation, copied
operation for operation: every packet's XY path lives on [L, h, w]
grids, each path cell's read time comes from a max-plus closed form of
the serial hop recurrence (a directional exclusive cummax), every read
sees the PRE-call port state, and each (cell, port) queue commits with
reductions over the packets.  It is the plain version of the
`noc_route` kernel (`csrc/noc_route.cu`, wrapper `ops/noc_route.py`),
and returns a new state, like the JAX function.

Ports: 0=RIGHT 1=LEFT 2=UP 3=DOWN 4=SELF 5=INJECT; queue row of (tile,
port) = tile * 6 + port, then one scratch row.
"""

from __future__ import annotations

import dataclasses

import torch

from graphite_tpu_torch.engine.state import _TensorTree
from graphite_tpu_torch.models import queue_models as qm
from graphite_tpu_torch.models.network_emesh import mesh_dims
from graphite_tpu_torch.models.queue_models import (
    QueueArrays, QueueParams, make_queues,
)
from graphite_tpu_torch.time_types import cycles_to_ps, ps_to_cycles

I64 = torch.int64
NUM_PORTS = 6
PORT_RIGHT, PORT_LEFT, PORT_UP, PORT_DOWN, PORT_SELF, PORT_INJECT = range(6)
NEG = -(2**61)


@dataclasses.dataclass(frozen=True)
class HopByHopParams:
    n_tiles: int
    mesh_width: int
    mesh_height: int
    router_delay: int          # cycles
    link_delay: int            # cycles
    flit_width_bits: int
    freq_mhz: int
    queue: QueueParams
    contention_enabled: bool = True

    @classmethod
    def from_config(cls, sc, network: str) -> "HopByHopParams":
        from graphite_tpu_torch.models.network_user import (
            _network_domain_freq_mhz,
        )

        cfg = sc.cfg
        sec = "network/emesh_hop_by_hop"
        w, h = mesh_dims(sc.application_tiles)
        qenabled = cfg.get_bool(f"{sec}/queue_model/enabled", True)
        qtype = cfg.get_string(f"{sec}/queue_model/type", "history_tree")
        return cls(
            n_tiles=sc.application_tiles,
            mesh_width=w,
            mesh_height=h,
            router_delay=cfg.get_int(f"{sec}/router/delay", 1),
            link_delay=cfg.get_int(f"{sec}/link/delay", 1),
            flit_width_bits=cfg.get_int(f"{sec}/flit_width", 64),
            freq_mhz=_network_domain_freq_mhz(
                sc, "NETWORK_USER" if network == "user" else "NETWORK_MEMORY"),
            queue=QueueParams.from_config(cfg, qtype, 1),
            contention_enabled=qenabled,
        )


@dataclasses.dataclass
class NocState(_TensorTree):
    queues: QueueArrays   # [n_tiles*6 + 1] port queues (+ scratch)


def init_noc_state(p: HopByHopParams, device) -> NocState:
    return NocState(queues=make_queues(p.n_tiles * NUM_PORTS + 1, p.queue,
                                       device))


def route_hop_by_hop_plain(p: HopByHopParams, nst: NocState,
                           src: torch.Tensor, dst: torch.Tensor,
                           bits: torch.Tensor, t_send_ps: torch.Tensor,
                           mask: torch.Tensor, enabled: torch.Tensor):
    """Route one packet a lane (`route_hop_by_hop`, `:123-185`); returns
    (new NocState, arrival_ps, zero_load_ps, contention_ps), int64[L]."""
    src = src.to(I64)
    dst = dst.to(I64)
    live = mask & torch.as_tensor(enabled, device=src.device)
    flits = torch.clamp(torch.div(bits.to(I64) + p.flit_width_bits - 1,
                                  p.flit_width_bits, rounding_mode="floor"),
                        min=1)
    t0 = ps_to_cycles(t_send_ps, p.freq_mhz)   # network-clock cycles
    w = p.mesh_width
    sx, sy = src % w, torch.div(src, w, rounding_mode="floor")
    dx, dy = dst % w, torch.div(dst, w, rounding_mode="floor")
    dist = torch.abs(sx - dx) + torch.abs(sy - dy)
    step_cyc = p.router_delay + p.link_delay
    zero_load = p.router_delay + (dist + 1) * step_cyc

    if p.contention_enabled:
        data, contention = _dense_contention(
            p, nst.queues.data, live, flits, t0, sx, sy, dx, dy, dist)
        queues = QueueArrays(data, nst.queues.mavg_buf, nst.queues.mavg_pos,
                             nst.queues.mavg_cnt)
        t = t0 + zero_load + contention
    else:
        queues = nst.queues
        contention = torch.zeros_like(t0)
        t = t0 + zero_load

    ser = torch.where(src == dst, 0, flits)
    t = t + ser
    zero_load = torch.where(live, zero_load + ser, 0)
    arrival_ps = torch.where(live, cycles_to_ps(t, p.freq_mhz), t_send_ps)
    zero_load_ps = cycles_to_ps(zero_load, p.freq_mhz)
    contention_ps = torch.where(live, cycles_to_ps(contention, p.freq_mhz),
                                0)
    return NocState(queues), arrival_ps, zero_load_ps, contention_ps


def _excl_cummax(v: torch.Tensor, dim: int, forward: bool) -> torch.Tensor:
    """Exclusive cummax along `dim`, in the direction of travel."""
    if forward:
        c = torch.cummax(v, dim=dim).values
        c = c.narrow(dim, 0, v.shape[dim] - 1)
        pad = torch.full_like(v.narrow(dim, 0, 1), NEG)
        return torch.cat([pad, c], dim=dim)
    c = torch.flip(torch.cummax(torch.flip(v, [dim]), dim=dim).values, [dim])
    c = c.narrow(dim, 1, v.shape[dim] - 1)
    pad = torch.full_like(v.narrow(dim, 0, 1), NEG)
    return torch.cat([c, pad], dim=dim)


def _dense_contention(p, data, live, flits, t0, sx, sy, dx, dy, dist):
    """Per-port contention of every packet at once (`_dense_contention`,
    `network_hop_by_hop.py:188-377`).  Returns (new queue data,
    contention cycles int64[L])."""
    w, h = p.mesh_width, p.mesh_height
    dev = data.device
    step_cyc = p.router_delay + p.link_delay
    X = torch.arange(w, dtype=I64, device=dev)[None, None, :]
    Y = torch.arange(h, dtype=I64, device=dev)[None, :, None]
    sx_, sy_ = sx[:, None, None], sy[:, None, None]
    dx_, dy_ = dx[:, None, None], dy[:, None, None]
    live_ = live[:, None, None]
    t0_ = t0[:, None, None]
    proc = flits[:, None, None]
    grid = data[: w * h * NUM_PORTS].reshape(h, w, NUM_PORTS, qm.N_COLS)

    def port_state(d):
        return grid[None, :, :, d, :]       # [1, h, w, 10]

    def delay_at(d, arr, member):
        st = port_state(d)
        qt = st[..., qm.COL_QT]
        if p.queue.history:
            too_old = p.queue.analytical_enabled & (
                (arr + proc) < st[..., qm.COL_WS])
            mg1 = qm._mg1_wait(
                st[..., qm.COL_N_ARR], st[..., qm.COL_SUM_ST],
                st[..., qm.COL_SUM_ST2], st[..., qm.COL_NEWEST])
            dly = torch.where(too_old, mg1, torch.clamp(qt - arr, min=0))
        else:
            too_old = torch.zeros(arr.shape, dtype=torch.bool, device=dev)
            dly = torch.clamp(qt - arr, min=0)
        return torch.where(member, dly, 0), too_old

    on_row = Y == sy_
    on_col = X == dx_
    m_right = live_ & on_row & (X >= sx_) & (X < dx_)
    m_left = live_ & on_row & (X <= sx_) & (X > dx_)
    m_up = live_ & on_col & (Y >= sy_) & (Y < dy_)
    m_down = live_ & on_col & (Y <= sy_) & (Y > dy_)
    m_self = live_ & (X == dx_) & (Y == dy_)
    m_inject = live_ & (X == sx_) & (Y == sy_)
    steps_h = torch.abs(X - sx_)
    steps_v = torch.abs(dx_ - sx_) + torch.abs(Y - sy_)
    steps_self = dist[:, None, None]

    def qt_of(d):
        return port_state(d)[..., qm.COL_QT]

    t0_cells = t0_.expand(m_inject.shape)
    d_inj_cells, too_inj = delay_at(PORT_INJECT, t0_cells, m_inject)
    base = t0_ + p.router_delay + d_inj_cells.sum((1, 2))[:, None, None]
    going_right = (dx > sx)[:, None, None]
    going_up = (dy > sy)[:, None, None]

    qt_h = torch.where(m_right, qt_of(PORT_RIGHT),
                       torch.where(m_left, qt_of(PORT_LEFT), NEG))
    v_h = torch.where(m_right | m_left, qt_h - steps_h * step_cyc, NEG)
    excl_h = torch.where(going_right, _excl_cummax(v_h, 2, True),
                         _excl_cummax(v_h, 2, False))
    t_read_h = steps_h * step_cyc + torch.maximum(base, excl_h)
    h_all = v_h.amax(dim=(1, 2), keepdim=True)

    qt_v = torch.where(m_up, qt_of(PORT_UP),
                       torch.where(m_down, qt_of(PORT_DOWN), NEG))
    v_v = torch.where(m_up | m_down, qt_v - steps_v * step_cyc, NEG)
    carry_v = torch.maximum(base, h_all)
    excl_v = torch.where(going_up, _excl_cummax(v_v, 1, True),
                         _excl_cummax(v_v, 1, False))
    t_read_v = steps_v * step_cyc + torch.maximum(carry_v, excl_v)
    v_all = v_v.amax(dim=(1, 2), keepdim=True)
    t_read_s = steps_self * step_cyc + torch.maximum(carry_v, v_all)

    planes = ((PORT_RIGHT, m_right, t_read_h), (PORT_LEFT, m_left, t_read_h),
              (PORT_UP, m_up, t_read_v), (PORT_DOWN, m_down, t_read_v),
              (PORT_SELF, m_self, t_read_s),
              (PORT_INJECT, m_inject, t0_cells))
    new_grid = grid.clone()
    span = p.queue.history_span
    contention = torch.zeros_like(t0)
    for d, member, arr in planes:
        if d == PORT_INJECT:
            dly, too_old = d_inj_cells, too_inj
        else:
            dly, too_old = delay_at(d, arr, member)
        contention = contention + dly.sum((1, 2))
        in_win = member & ~too_old
        st = grid[:, :, d, :]                          # [h, w, 10]
        qt = st[..., qm.COL_QT]
        any_win = in_win.any(dim=0)
        arr_max = torch.where(in_win, arr, -(2**62)).amax(dim=0)
        proc_sum = torch.where(in_win, proc, 0).sum(dim=0)
        qt_new = torch.where(any_win, torch.maximum(qt, arr_max) + proc_sum,
                             qt)
        end = arr + dly + proc
        newest = torch.maximum(st[..., qm.COL_NEWEST],
                               torch.where(member, end, 0).amax(dim=0))
        ws_new = torch.where(
            any_win, torch.maximum(st[..., qm.COL_WS], qt_new - span),
            st[..., qm.COL_WS])
        n_mem = member.sum(dim=0, dtype=I64)
        p_sum = torch.where(member, proc, 0).sum(dim=0)
        new_grid[:, :, d, :] = torch.stack([
            qt_new,
            ws_new,
            newest,
            st[..., qm.COL_SUM_ST] + p_sum,
            st[..., qm.COL_SUM_ST2] + torch.where(member, proc * proc,
                                                  0).sum(dim=0),
            st[..., qm.COL_N_ARR] + n_mem,
            st[..., qm.COL_REQS] + n_mem,
            st[..., qm.COL_UTIL] + p_sum,
            st[..., qm.COL_DELAY] + dly.sum(dim=0),
            st[..., qm.COL_ANA] + (member & too_old).sum(dim=0, dtype=I64),
        ], dim=-1)
    out = data.clone()
    out[: w * h * NUM_PORTS] = new_grid.reshape(w * h * NUM_PORTS,
                                                qm.N_COLS)
    return out, contention
