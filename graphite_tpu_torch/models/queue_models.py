"""Contention queue models over a packed [N, 10] int64 queue tensor.

Port of `graphite_tpu/models/queue_models.py` (reference:
`common/shared_models/queue_models/`).  Four kinds: `basic` (tail
delay, optional moving average of packet times), `m_g_1` (analytical
waiting time from running service-time moments), and `history_list` /
`history_tree`, which the JAX package models as a windowed tail with
the M/G/1 fallback for packets older than the tracked window.

 - `compute_queue_delay`: one queue a lane (no path of either package
   calls it; `tests/test_queue_models.py` does), plain PyTorch only;
 - `scatter_queue_delay`: lanes address arbitrary, possibly shared
   queues (the ATAC hubs): every lane reads the pre-call state, the
   occupancy commits as a scatter-max of in-window arrivals then a
   scatter-add of their processing times.  Its kernel form lives in
   `csrc/atac_route.cu`.

Masked-no-op invariant: a call whose mask is all False leaves the state
unchanged, because masked lanes go to the scratch queue (the last row)
with zero deltas and a max against values that are never negative.

`_mg1_wait` is float64, evaluated as separate IEEE operations (no fused
multiply-add), like XLA's CPU lowering; the kernels use the same order
with explicitly rounded intrinsics (`csrc/queue_common.cuh`).
"""

from __future__ import annotations

import dataclasses

import torch

from graphite_tpu_torch.engine.state import _TensorTree

I64 = torch.int64
F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class QueueParams:
    kind: str = "history_tree"   # basic | m_g_1 | history_list | history_tree
    # [queue_model/basic]
    moving_avg_enabled: bool = True
    moving_avg_window: int = 64
    # [queue_model/history_list] / [queue_model/history_tree]
    max_list_size: int = 100
    analytical_enabled: bool = True
    # minimum processing time: sizes the tracked-history span
    min_processing_time: int = 1

    @classmethod
    def from_config(cls, cfg, kind: str, min_processing_time: int = 1):
        if kind in ("history_list", "history_tree"):
            sec = f"queue_model/{kind}"
            return cls(
                kind=kind,
                max_list_size=cfg.get_int(f"{sec}/max_list_size", 100),
                analytical_enabled=cfg.get_bool(
                    f"{sec}/analytical_model_enabled", True),
                min_processing_time=min_processing_time,
            )
        if kind == "basic":
            return cls(
                kind="basic",
                moving_avg_enabled=cfg.get_bool(
                    "queue_model/basic/moving_avg_enabled", False),
                moving_avg_window=cfg.get_int(
                    "queue_model/basic/moving_avg_window_size", 1),
                min_processing_time=min_processing_time,
            )
        if kind == "m_g_1":
            return cls(kind="m_g_1", min_processing_time=min_processing_time)
        raise ValueError(f"unknown queue model {kind!r}")

    @property
    def history(self) -> bool:
        return self.kind in ("history_list", "history_tree")

    @property
    def history_span(self) -> int:
        """Approximate span of the reference's interval list: at least
        max_list_size busy intervals of >= min_processing_time each."""
        return self.max_list_size * max(self.min_processing_time, 1)


# column layout of QueueArrays.data (`queue_models.py:98-111`)
COL_QT = 0        # queue_time: end of the busy tail
COL_WS = 1        # window_start: oldest tracked time (history_*)
COL_NEWEST = 2    # newest_arrival (M/G/1 moments)
COL_SUM_ST = 3
COL_SUM_ST2 = 4
COL_N_ARR = 5
COL_REQS = 6      # total_requests
COL_UTIL = 7      # total_utilized
COL_DELAY = 8     # total_delay
COL_ANA = 9       # analytical_used
N_COLS = 10


@dataclasses.dataclass
class QueueArrays(_TensorTree):
    """State of N independent queues (the JAX `QueueArrays`, leaf for
    leaf; the moving-average buffers are read by `basic` queues with a
    moving average in `compute_queue_delay` only)."""

    data: torch.Tensor       # int64[N, 10]
    mavg_buf: torch.Tensor   # int64[N, W]
    mavg_pos: torch.Tensor   # int32[N]
    mavg_cnt: torch.Tensor   # int32[N]


def make_queues(n: int, params: QueueParams, device) -> QueueArrays:
    W = params.moving_avg_window if (
        params.kind == "basic" and params.moving_avg_enabled) else 1
    return QueueArrays(
        data=torch.zeros((n, N_COLS), dtype=I64, device=device),
        mavg_buf=torch.zeros((n, W), dtype=I64, device=device),
        mavg_pos=torch.zeros(n, dtype=torch.int32, device=device),
        mavg_cnt=torch.zeros(n, dtype=torch.int32, device=device),
    )


def _mg1_wait(n_arrivals, sum_st, sum_st2, newest_arrival) -> torch.Tensor:
    """`queue_model_m_g_1.cc:18-47` waiting time, elementwise over the
    running moments, in the JAX expression's order."""
    n = n_arrivals.to(F64)
    have = n_arrivals > 0
    n_safe = torch.where(have, n, 1.0)
    mean_st = sum_st.to(F64) / n_safe
    var_st = sum_st2.to(F64) / n_safe - mean_st * mean_st
    service_rate = 1.0 / torch.clamp(mean_st, min=1e-12)
    arrival_rate = n / torch.clamp(newest_arrival.to(F64), min=1e-12)
    arrival_rate = torch.minimum(arrival_rate, 0.999 * service_rate)
    wait = 0.5 * service_rate * arrival_rate * (
        1.0 / (service_rate * service_rate) + var_st
    ) / (service_rate - arrival_rate)
    return torch.where(have, torch.ceil(wait), 0.0).to(I64)


def compute_queue_delay(params: QueueParams, q: QueueArrays,
                        pkt_time: torch.Tensor,
                        processing_time: torch.Tensor,
                        mask: torch.Tensor):
    """`QueueModel::computeQueueDelay`, one queue a lane
    (`queue_models.py:197-275`).  Returns (new state, delay int64[N])."""
    pkt_time = pkt_time.to(I64)
    proc = torch.clamp(processing_time.to(I64), min=1)
    data = q.data
    qt, ws, newest = data[:, COL_QT], data[:, COL_WS], data[:, COL_NEWEST]
    mavg_buf, mavg_pos, mavg_cnt = q.mavg_buf, q.mavg_pos, q.mavg_cnt

    if params.kind == "basic":
        if params.moving_avg_enabled:
            W = params.moving_avg_window
            lanes = torch.arange(mavg_buf.shape[0], device=data.device)
            pos = mavg_pos.to(I64)
            mavg_buf = mavg_buf.clone()
            mavg_buf[lanes, pos] = torch.where(mask, pkt_time,
                                               mavg_buf[lanes, pos])
            cnt = torch.clamp(mavg_cnt + mask.to(torch.int32), max=W)
            ref = torch.where(
                cnt > 0,
                torch.div(mavg_buf.sum(dim=1), torch.clamp(cnt, min=1),
                          rounding_mode="floor"),
                pkt_time).to(I64)
            mavg_pos = torch.where(mask, torch.remainder(mavg_pos + 1, W),
                                   mavg_pos).to(torch.int32)
            mavg_cnt = cnt.to(torch.int32)
        else:
            ref = pkt_time
        delay = torch.clamp(qt - ref, min=0)
        new_qt = torch.where(mask, torch.maximum(qt, ref) + proc, qt)
        new_ws = ws
        mg1_mask = torch.zeros_like(mask)
        analytical = torch.zeros_like(mask)
    elif params.kind == "m_g_1":
        delay = _mg1_wait(data[:, COL_N_ARR], data[:, COL_SUM_ST],
                          data[:, COL_SUM_ST2], newest)
        new_qt, new_ws = qt, ws
        mg1_mask = mask
        analytical = mask
    else:  # history_list / history_tree
        too_old = params.analytical_enabled & ((pkt_time + proc) < ws)
        mg1 = _mg1_wait(data[:, COL_N_ARR], data[:, COL_SUM_ST],
                        data[:, COL_SUM_ST2], newest)
        tail = torch.clamp(qt - pkt_time, min=0)
        delay = torch.where(too_old, mg1, tail)
        in_window = mask & ~too_old
        cand_qt = torch.maximum(qt, pkt_time) + proc
        new_qt = torch.where(in_window, cand_qt, qt)
        new_ws = torch.where(
            in_window, torch.maximum(ws, cand_qt - params.history_span), ws)
        mg1_mask = mask
        analytical = mask & too_old

    end = pkt_time + delay + proc
    zero = torch.zeros_like(proc)
    new_data = torch.stack([
        new_qt,
        new_ws,
        torch.where(mg1_mask, torch.maximum(newest, end), newest),
        data[:, COL_SUM_ST] + torch.where(mg1_mask, proc, zero),
        data[:, COL_SUM_ST2] + torch.where(mg1_mask, proc * proc, zero),
        data[:, COL_N_ARR] + mg1_mask.to(I64),
        data[:, COL_REQS] + mask.to(I64),
        data[:, COL_UTIL] + torch.where(mask, proc, zero),
        data[:, COL_DELAY] + torch.where(mask, delay, zero),
        data[:, COL_ANA] + analytical.to(I64),
    ], dim=1)
    return (QueueArrays(new_data, mavg_buf, mavg_pos, mavg_cnt),
            torch.where(mask, delay, zero))


def scatter_queue_delay(params: QueueParams, q: QueueArrays,
                        qid: torch.Tensor, pkt_time: torch.Tensor,
                        processing_time: torch.Tensor, mask: torch.Tensor):
    """Queue delay where lanes address arbitrary (possibly shared) queues
    (`queue_models.py:277-346`): every lane reads the pre-call row; the
    occupancy commits as a scatter-max of in-window arrivals, then a
    scatter-add of their processing times; `window_start` follows the
    post-commit queue time; masked lanes go to the scratch row N - 1.
    Returns (new state, delay int64[L])."""
    pkt_time = pkt_time.to(I64)
    proc = torch.clamp(processing_time.to(I64), min=1)
    N = q.data.shape[0]
    qid = torch.where(mask, qid.to(I64), N - 1)
    zero = torch.zeros_like(proc)

    row = q.data[qid]                                   # [L, 10]
    qt = row[:, COL_QT]
    if params.history:
        too_old = params.analytical_enabled & (
            (pkt_time + proc) < row[:, COL_WS])
        mg1 = _mg1_wait(row[:, COL_N_ARR], row[:, COL_SUM_ST],
                        row[:, COL_SUM_ST2], row[:, COL_NEWEST])
        delay = torch.where(too_old, mg1, torch.clamp(qt - pkt_time, min=0))
        in_window = mask & ~too_old
    else:  # basic semantics (no moving average in scatter form)
        delay = torch.clamp(qt - pkt_time, min=0)
        in_window = mask
        too_old = torch.zeros_like(mask)

    data = q.data.clone()
    qt_col = data[:, COL_QT].scatter_reduce(
        0, qid, torch.where(in_window, pkt_time, zero), "amax",
        include_self=True)
    qt_col = qt_col.index_add(0, qid, torch.where(in_window, proc, zero))
    data[:, COL_QT] = qt_col
    qt_new = qt_col[qid]
    end = pkt_time + delay + proc
    data[:, COL_WS] = data[:, COL_WS].scatter_reduce(
        0, qid, torch.where(in_window, qt_new - params.history_span,
                            -(2**62)), "amax", include_self=True)
    data[:, COL_NEWEST] = data[:, COL_NEWEST].scatter_reduce(
        0, qid, torch.where(mask, end, zero), "amax", include_self=True)
    m = mask.to(I64)
    for col, v in ((COL_SUM_ST, torch.where(mask, proc, zero)),
                   (COL_SUM_ST2, torch.where(mask, proc * proc, zero)),
                   (COL_N_ARR, m), (COL_REQS, m),
                   (COL_UTIL, torch.where(mask, proc, zero)),
                   (COL_DELAY, torch.where(mask, delay, zero)),
                   (COL_ANA, (mask & too_old).to(I64))):
        data[:, col] = data[:, col].index_add(0, qid, v)
    return (QueueArrays(data, q.mavg_buf, q.mavg_pos, q.mavg_cnt),
            torch.where(mask, delay, zero))
