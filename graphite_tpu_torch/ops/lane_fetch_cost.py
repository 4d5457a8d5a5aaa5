"""`lane_fetch_cost`: per-lane record fetch, done/active latch and cost.

Replaces the fetch (`graphite_tpu/engine/step.py:193-241`), the done/
active latch (`:242-251`), the `lax_p2p` hold (`:253-272`) and the
classify + cost block (`:342-403`) of the JAX step.  Kernel:
`csrc/lane_fetch_cost.cu`, one thread a lane, launched through a binding
(`build.Kernel.launch_bound`): its arguments are validated once per set
of tensors, and the static cost table is read into the argument block
then (the port never writes the table).  Under `lax_p2p` the wrapper
launches the kernel's P2P instantiation (`KERNEL_P2P`, counted apart as
`lane_fetch_cost[p2p]`), which reads the round counter and the slack as
well.  For CPU tensors the wrapper runs `lane_fetch_cost_plain`, the
same function in PyTorch; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from operator import attrgetter

import torch

from graphite_tpu_torch.engine.state import CoreState, DeviceTrace, Lanes
from graphite_tpu_torch.intmath import nn_ceil_div
from graphite_tpu_torch.ops.build import Kernel, check, pack_args
from graphite_tpu_torch.trace.schema import FLAG_BRANCH_TAKEN, Op

N_COSTS = 20
# (field, dtype) of the trace columns and of the lane outputs, in the
# pointer order of the kernel's `FetchArgs` struct (csrc/lane_fetch_cost.cu)
_TRACE = (("op", torch.uint8), ("flags", torch.uint8), ("pc", torch.int64),
          ("aux0", torch.int32), ("aux1", torch.int32),
          ("dyn_ps", torch.int64))
_LANES = (("op", torch.int32), ("flags", torch.int32), ("pc", torch.int64),
          ("aux0", torch.int32), ("aux1", torch.int32),
          ("dyn_ps", torch.int64), ("bp_index", torch.int32),
          ("bp_pred", torch.uint8), ("done", torch.bool),
          ("active", torch.bool), ("cost_ps", torch.int64))
_trace_get = attrgetter(*(n for n, _ in _TRACE))
_lanes_get = attrgetter(*(n for n, _ in _LANES))
_COST_TABLE = 13                  # its place in the bound tensors


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`FetchArgs` in
    csrc/lane_fetch_cost.cu: the 25 pointers, then T, L, B, the predictor
    mask, the three plain values and the 20 static costs)."""
    bp_enabled, bp_penalty, syscall_rt_ps = key
    T = tensors[0].shape[0]
    L = tensors[5].shape[1]
    B = tensors[4].shape[1]
    t = (T,)
    specs = [("core.idx", torch.int32, t), ("core.clock_ps", torch.int64, t),
             ("core.freq_mhz", torch.int32, t), ("done", torch.bool, t),
             ("core.bp_bits", torch.uint8, (T, B))]
    specs += [(f"trace.{n}", dt, (T, L)) for n, dt in _TRACE]
    specs += [("enabled", torch.bool, ()), ("qend", torch.int64, ()),
              ("cost_table", torch.int64, (N_COSTS,))]
    specs += [(f"lanes.{n}", dt, t) for n, dt in _LANES]
    costs = tensors[_COST_TABLE]
    check(costs, "cost_table", torch.int64, (N_COSTS,), tensors[0].device)
    # pc mod B as a mask when B is a power of two
    bp_mask = B - 1 if B & (B - 1) == 0 else -1
    return pack_args(tensors, specs, (
        T, L, B, bp_mask, bool(bp_enabled), bp_penalty, syscall_rt_ps,
        *costs.tolist()))


def _pack_p2p(tensors: tuple, key: tuple):
    """`P2PArgs`: the `FetchArgs` block, then the round counter's pointer
    and the slack in ps."""
    *key, slack_ps = key
    block = _pack(tensors[:-1], tuple(key))
    rnd = check(tensors[-1], "p2p_round", torch.int32, (),
                tensors[0].device)
    words = [*block, rnd, int(slack_ps)]
    return (ctypes.c_int64 * len(words))(*words)


KERNEL = Kernel("lane_fetch_cost", "gt_lane_fetch_cost", pack=_pack)
KERNEL_P2P = Kernel("lane_fetch_cost[p2p]", "gt_lane_fetch_cost_p2p",
                    pack=_pack_p2p, lib="lane_fetch_cost")
_U32 = 0xFFFFFFFF


def p2p_partner(p2p_round: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Each lane's partner this round (`step.py:259-266`): a uint32 hash
    of (round, tile), held in int64 and masked to 32 bits, then a tile
    other than the lane's own (itself only when T = 1)."""
    tiles = torch.arange(n_tiles, dtype=torch.int64,
                         device=p2p_round.device)
    r = p2p_round.to(torch.int64) & _U32
    rnd = (r * 747796405 + tiles * 2891336453) & _U32
    rnd = ((rnd ^ (rnd >> 13)) * 1103515245) & _U32
    return (tiles + 1 + rnd % max(n_tiles - 1, 1)) % n_tiles


def lane_fetch_cost_plain(trace: DeviceTrace, core: CoreState,
                          done: torch.Tensor, enabled: torch.Tensor,
                          qend: torch.Tensor, cost_table: torch.Tensor,
                          bp_enabled: bool, bp_penalty: int,
                          syscall_rt_ps: int, lanes: Lanes,
                          p2p_slack_ps: "int | None" = None,
                          p2p_round: "torch.Tensor | None" = None) -> None:
    L = trace.length
    bp_size = core.bp_bits.shape[1]
    idx = torch.clamp(core.idx, 0, L - 1).to(torch.int64)[:, None]

    def fetch(col):
        return torch.gather(col, 1, idx)[:, 0]

    op = fetch(trace.op).to(torch.int32)
    flags = fetch(trace.flags).to(torch.int32)
    pc = fetch(trace.pc)
    aux1 = fetch(trace.aux1)
    dyn_ps = fetch(trace.dyn_ps)
    # pc is the zero-extended uint32 column: fmod == the JAX uint32 rem
    bp_index = torch.fmod(pc, bp_size).to(torch.int32)
    bp_pred = torch.gather(core.bp_bits, 1,
                           bp_index.to(torch.int64)[:, None])[:, 0]

    stream_end = (op == Op.NOP) | (op == Op.THREAD_EXIT)
    done_now = done | stream_end
    active = ~done_now & (core.clock_ps < qend)
    if p2p_slack_ps is not None:
        # hold a lane more than the slack ahead of a partner that is
        # still running after this iteration's latch
        partner = p2p_partner(p2p_round, done.shape[0])
        ahead = core.clock_ps > core.clock_ps[partner] + p2p_slack_ps
        active = active & ~(ahead & ~done_now[partner])

    is_branch = op == Op.BRANCH
    is_dynamic = (op >= Op.DYNAMIC_MISC) & (op < 20)
    static_cycles = cost_table[torch.clamp(op, 0, 19).to(torch.int64)]
    taken = ((flags & FLAG_BRANCH_TAKEN) != 0).to(torch.uint8)
    if bp_enabled:
        branch_cycles = torch.where(bp_pred == taken, 1, bp_penalty)
    else:
        branch_cycles = torch.ones_like(static_cycles)
    cycles = torch.where(is_branch, branch_cycles, static_cycles)
    freq = core.freq_mhz.to(torch.int64)
    cost = nn_ceil_div(cycles * 1_000_000, freq)
    cost = torch.where(is_dynamic, dyn_ps, cost)
    cost = torch.where(op < 20, cost, 0)
    cost = torch.where((op == Op.SYSCALL) | (op == Op.DVFS_GET),
                       syscall_rt_ps, cost)
    cost = torch.where(op == Op.BBLOCK,
                       nn_ceil_div(aux1.to(torch.int64) * 1_000_000, freq),
                       cost)
    cost = torch.where(enabled, cost, 0)

    lanes.op.copy_(op)
    lanes.flags.copy_(flags)
    lanes.pc.copy_(pc)
    lanes.aux0.copy_(fetch(trace.aux0))
    lanes.aux1.copy_(aux1)
    lanes.dyn_ps.copy_(dyn_ps)
    lanes.bp_index.copy_(bp_index)
    lanes.bp_pred.copy_(bp_pred)
    lanes.done.copy_(done_now)
    lanes.active.copy_(active)
    lanes.cost_ps.copy_(cost)


def lane_fetch_cost(trace: DeviceTrace, core: CoreState, done: torch.Tensor,
                    enabled: torch.Tensor, qend: torch.Tensor,
                    cost_table: torch.Tensor, *, bp_enabled: bool,
                    bp_penalty: int, syscall_rt_ps: int,
                    lanes: Lanes, p2p_slack_ps: "int | None" = None,
                    p2p_round: "torch.Tensor | None" = None) -> None:
    """Fill `lanes`' fetch block (op … cost_ps) for one iteration.  With
    `p2p_slack_ps` (the `lax_p2p` scheme) a lane more than the slack
    ahead of its partner this round (`p2p_round`, int32[]) is inactive."""
    if done.device.type == "cpu":
        lane_fetch_cost_plain(trace, core, done, enabled, qend, cost_table,
                              bp_enabled, bp_penalty, syscall_rt_ps, lanes,
                              p2p_slack_ps, p2p_round)
        return
    if done.device.type != "cuda":
        raise ValueError(f"lane_fetch_cost: unsupported device {done.device}")
    tensors, key = bound_args(trace, core, done, enabled, qend, cost_table,
                              bp_enabled, bp_penalty, syscall_rt_ps, lanes)
    if p2p_slack_ps is None:
        KERNEL.launch_bound(tensors, key)
    else:
        KERNEL_P2P.launch_bound((*tensors, p2p_round),
                                (*key, int(p2p_slack_ps)))


def bound_args(trace, core, done, enabled, qend, cost_table, bp_enabled,
               bp_penalty, syscall_rt_ps, lanes) -> tuple:
    """The (tensors, key) a call binds, in `FetchArgs` order."""
    return ((core.idx, core.clock_ps, core.freq_mhz, done, core.bp_bits,
             *_trace_get(trace), enabled, qend, cost_table,
             *_lanes_get(lanes)),
            (bool(bp_enabled), int(bp_penalty), int(syscall_rt_ps)))
