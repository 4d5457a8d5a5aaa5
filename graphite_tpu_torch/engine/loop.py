"""The quantum loop driver.

Port of `graphite_tpu/engine/step.py` `_quantum_loop` (`:1207-1264`) and
`run_simulation` (`:1285-1454`) for the `lax` and `lax_p2p` (one unbounded
quantum, qend = 2**61) and `lax_barrier` clock-skew schemes.  The JAX
package runs both loops on the device as one compiled region (under
`barrier_host`, one region a batch of quanta, `barrier_host_batch`
`:1457-1553`, which reaches the same state); here the host drives them,
with the loop state kept on the device where it can be:

 - the advanced-lane count is summed on the device (`Lanes.progress`,
   by `lane_commit`) and read to the host once per block of
   `inner_block` iterations — never once per iteration;
 - the quantum boundary `qend` is computed on the device and handed to
   the kernels as a device scalar;
 - per quantum, one small host read brings back the loop-control flags
   (all done, overflow, zero-progress window jump or deadlock).

`n_quanta`, the deadlock and overflow conditions, the zero-progress
window jump and `n_iterations` follow `run_simulation` exactly.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.state import DeviceTrace, Lanes, SimState
from graphite_tpu_torch.engine.step import (
    NO_MODELS, EngineParams, ModelCtx, subquantum_iteration,
)

INF_QEND = 2**61
BIG = 2**62


def _wrap_i32(x: int) -> int:
    """The JAX loop sums progress in int32."""
    return (x + 2**31) % 2**32 - 2**31


def quantum_loop(params: EngineParams, trace: DeviceTrace, state: SimState,
                 qend: torch.Tensor, lanes: Lanes,
                 cost_table: torch.Tensor,
                 models: ModelCtx = NO_MODELS) -> tuple[int, int]:
    """Blocks of `inner_block` iterations until a block makes no progress
    (`step.py:1207`).  Returns (total progress, iterations run)."""
    total, iters = 0, 0
    while True:
        lanes.progress.zero_()
        for _ in range(params.inner_block):
            subquantum_iteration(params, trace, state, qend, lanes,
                                 cost_table, models)
        blk = _wrap_i32(int(lanes.progress.item()))
        total = _wrap_i32(total + blk)
        iters += params.inner_block
        if blk <= 0:
            return total, iters


def run_simulation(params: EngineParams, trace: DeviceTrace,
                   state: SimState, quantum_ps: "int | None",
                   max_quanta: int, lanes: Lanes,
                   cost_table: torch.Tensor,
                   models: ModelCtx = NO_MODELS) -> tuple[int, bool, int]:
    """Quanta until every tile is done, a ring overflowed, a quantum
    deadlocked or `max_quanta` ran (`step.py:1285`); `state` is updated
    in place.  Returns (n_quanta, deadlock, n_iterations)."""
    dev = state.done.device
    qend = torch.full((), INF_QEND, dtype=torch.int64, device=dev)
    prev_qend = torch.zeros((), dtype=torch.int64, device=dev)
    n, iters, deadlock = 0, 0, False
    all_done, overflow = [bool(x) for x in torch.stack(
        [state.done.all(), state.net.overflow]).tolist()]
    while not (all_done or overflow or deadlock) and n < max_quanta:
        clock, not_done = state.core.clock_ps, ~state.done
        if quantum_ps is not None:
            min_pending = torch.where(not_done, clock, BIG).min()
            boundary = (torch.div(min_pending, quantum_ps,
                                  rounding_mode="floor") + 1) * quantum_ps
            qend.copy_(torch.maximum(prev_qend + quantum_ps, boundary))
        progress, blk_iters = quantum_loop(params, trace, state, qend,
                                           lanes, cost_table, models)
        clock, not_done = state.core.clock_ps, ~state.done
        if quantum_ps is not None:
            ahead = torch.where(not_done & (clock >= qend), clock, BIG).min()
            have_ahead_t = ahead < BIG
            jump = (torch.div(ahead, quantum_ps, rounding_mode="floor")
                    + 1) * quantum_ps - quantum_ps
            if progress == 0:
                prev_qend = torch.where(not_done.any() & have_ahead_t, jump,
                                        qend)
            else:
                prev_qend = qend.clone()
        else:
            have_ahead_t = torch.zeros((), dtype=torch.bool, device=dev)
        flags = torch.stack([state.done.all(), state.net.overflow,
                             not_done.any(), have_ahead_t]).tolist()
        all_done, overflow, any_pending, have_ahead = (bool(x)
                                                       for x in flags)
        zero = progress == 0 and any_pending
        deadlock = zero and not have_ahead
        n += 1
        iters += blk_iters
    return n, deadlock, iters
