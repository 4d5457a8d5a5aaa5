"""`lane_commit`: per-lane commit — advance mask, clock, counters.

Replaces the commit of the JAX step (`graphite_tpu/engine/step.py:842-915`
and `:1098-1140` for the memoryless simple core), plain-run batching
(`:999-1066`) and the progress sum (`:1204`).  Kernel:
`csrc/lane_commit.cu`, one thread a lane, launched through a binding
(`build.Kernel.launch_bound`): its 48 tensor arguments are validated once
per set of tensors, not on every call.

Per lane: the `advance` mask over every unit's outputs; the clock's
max/where chain; `idx` += advance + follow-ons; the nine counters; the
one-bit predictor write (the lane's own (t, pc mod bp_size) cell); up to
KX follow-on PLAIN records (static non-branch ops, op <= MFENCE) charged
at the post-DVFS frequency while their cumulative start stays before
qend; `done` latched; and the advanced-lane count added to `progress`.
Under `lax_p2p` the round counter `p2p_round` goes up by one
(`:270`, int32, wrapping), after `lane_fetch_cost` has read it.
"""

from __future__ import annotations

from operator import attrgetter

import torch

from graphite_tpu_torch.engine.state import CoreState, Lanes, UserNetState
from graphite_tpu_torch.intmath import nn_ceil_div
from graphite_tpu_torch.ops.build import Kernel, pack_args
from graphite_tpu_torch.trace.schema import FLAG_BRANCH_TAKEN, Op

# (field, dtype) of the per-lane arguments, in the pointer order of the
# kernel's `CommitArgs` struct (csrc/lane_commit.cu)
_LANE_IN = (
    ("op", torch.int32), ("flags", torch.int32), ("aux0", torch.int32),
    ("dyn_ps", torch.int64), ("bp_index", torch.int32),
    ("bp_pred", torch.uint8), ("done", torch.bool), ("active", torch.bool),
    ("cost_ps", torch.int64), ("recv_now", torch.bool),
    ("recv_time", torch.int64), ("recv_lat", torch.int32),
    ("released", torch.bool), ("release_time", torch.int64),
    ("barrive_now", torch.bool), ("bsync_now", torch.bool),
    ("bsync_time", torch.int64), ("granted", torch.bool),
    ("mutex_wait_ps", torch.int64), ("cond_post_commit", torch.bool),
    ("pub_now", torch.bool), ("cjoin_now", torch.bool),
    ("cjoin_time", torch.int64), ("join_now", torch.bool),
    ("join_time", torch.int64),
)
_CORE = (
    ("clock_ps", torch.int64), ("idx", torch.int32),
    ("freq_mhz", torch.int32), ("instruction_count", torch.int64),
    ("execution_stall_ps", torch.int64), ("recv_instructions", torch.int64),
    ("recv_stall_ps", torch.int64), ("sync_instructions", torch.int64),
    ("sync_stall_ps", torch.int64), ("bp_correct", torch.int64),
    ("bp_incorrect", torch.int64),
)
_NET = (("packets_sent", torch.int64), ("packets_received", torch.int64),
        ("total_latency_ps", torch.int64))

# the longest follow-on window the kernel holds in registers (KX_MAX)
MAX_FOLLOW = 15
_lane_get = attrgetter(*(n for n, _ in _LANE_IN))
_core_get = attrgetter(*(n for n, _ in _CORE))
_net_get = attrgetter(*(n for n, _ in _NET))
_BP_BITS = 1 + len(_LANE_IN) + 3 + len(_CORE)   # its place in the args


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`CommitArgs` in
    csrc/lane_commit.cu: the 58 pointers — `p2p_round` None unless
    lax_p2p, the last nine None for the memoryless simple core — then T,
    L, B and KX)."""
    (n_follow,) = key
    if not 0 <= n_follow <= MAX_FOLLOW:
        raise ValueError(f"lane_commit: n_follow {n_follow} outside "
                         f"[0, {MAX_FOLLOW}]")
    T, L = tensors[0].shape
    B = tensors[_BP_BITS].shape[1]
    t = (T,)
    specs = [("trace.op", torch.uint8, (T, L))]
    specs += [(f"lanes.{n}", dt, t) for n, dt in _LANE_IN]
    specs += [("freq_new", torch.int32, t), ("en_post", torch.bool, ()),
              ("lanes.progress", torch.int32, (1,))]
    specs += [(f"core.{n}", dt, t) for n, dt in _CORE]
    specs += [("core.bp_bits", torch.uint8, (T, B))]
    specs += [(f"net.{n}", dt, t) for n, dt in _NET]
    specs += [("done", torch.bool, t), ("enabled", torch.bool, ()),
              ("qend", torch.int64, ()), ("cost_table", torch.int64, (20,)),
              ("p2p_round", torch.int32, ())]
    specs += [("lanes.mem_ok", torch.bool, t), ("req.slot", torch.int32, t),
              ("req.acc_ps", torch.int64, t),
              ("req.slot_lat_ps", torch.int64, (T, 3)),
              ("ioc_tile", torch.bool, t), ("lanes.ioc_clock", torch.int64, t),
              ("lanes.ioc_mem_stall", torch.int64, t),
              ("lanes.ioc_exec_stall", torch.int64, t),
              ("core.memory_stall_ps", torch.int64, t)]
    return pack_args(tensors, specs, (T, L, B, n_follow))


KERNEL = Kernel("lane_commit", "gt_lane_commit", pack=_pack)


def lane_commit_plain(trace_op: torch.Tensor, lanes: Lanes,
                      freq_new: torch.Tensor, en_post: torch.Tensor,
                      core: CoreState, net: UserNetState,
                      done: torch.Tensor, enabled: torch.Tensor,
                      qend: torch.Tensor, cost_table: torch.Tensor,
                      n_follow: int, req=None, ioc_tile=None,
                      p2p_round=None) -> None:
    i64 = torch.int64
    ln = lanes
    op, active = ln.op, ln.active
    is_branch = op == Op.BRANCH
    is_static = (op < Op.DYNAMIC_MISC) & ~is_branch
    is_dynamic = (op >= Op.DYNAMIC_MISC) & (op < 20)
    is_spawn = op == Op.SPAWN
    is_send = op == Op.SEND
    is_bblock = op == Op.BBLOCK
    is_simple_event = (
        (op == Op.THREAD_SPAWN) | (op == Op.BARRIER_INIT)
        | (op == Op.MUTEX_INIT) | (op == Op.MUTEX_UNLOCK)
        | (op == Op.ENABLE_MODELS) | (op == Op.DISABLE_MODELS)
        | (op == Op.DVFS_SET) | (op == Op.DVFS_GET) | (op == Op.SYSCALL)
        | (op == Op.COND_INIT))
    instr_like = is_static | is_branch
    dyn_plain = is_dynamic & ~is_spawn
    # records with memory slots commit once every slot completed
    mem_ok = ln.mem_ok if req is not None else True
    advance = active & (((instr_like | is_bblock) & mem_ok) | dyn_plain
                        | is_simple_event | is_send)
    advance = advance | ln.recv_now | ln.released | (active & is_spawn)
    advance = advance | ln.granted | ln.join_now | ln.cond_post_commit
    advance = advance | ln.barrive_now | ln.bsync_now | ln.cjoin_now
    advance = advance | ln.pub_now

    clock0 = core.clock_ps
    cost = ln.cost_ps
    # iocoom tiles take their instruction records' clock from
    # iocoom_commit; every other record pays cost + memory latency
    simple_instr = instr_like if ioc_tile is None else (
        instr_like & ~ioc_tile)
    mem_acc = req.acc_ps if req is not None else 0
    clock = torch.where(
        advance & (simple_instr | is_bblock | dyn_plain | is_simple_event
                   | is_send),
        clock0 + cost + torch.where(simple_instr | is_bblock, mem_acc, 0),
        clock0)
    if ioc_tile is not None:
        clock = torch.where(advance & instr_like & ioc_tile, ln.ioc_clock,
                            clock)
    clock = torch.where(active & is_spawn, torch.maximum(clock, ln.dyn_ps),
                        clock)
    clock = torch.where(ln.recv_now, torch.maximum(clock, ln.recv_time),
                        clock)
    clock = torch.where(ln.released,
                        torch.maximum(clock, ln.release_time), clock)
    clock = torch.where(ln.granted, clock + ln.mutex_wait_ps, clock)
    clock = torch.where(ln.join_now, ln.join_time, clock)
    clock = torch.where(ln.bsync_now, torch.maximum(clock, ln.bsync_time),
                        clock)
    clock = torch.where(ln.cjoin_now, torch.maximum(clock, ln.cjoin_time),
                        clock)

    # plain-run batching: follow-on PLAIN records at the post-DVFS freq
    T, L = trace_op.shape
    if n_follow > 0:
        idx_c = torch.clamp(core.idx, 0, L - 1)
        offs = torch.arange(1, n_follow + 1, dtype=torch.int32,
                            device=op.device)
        pos = idx_c[:, None] + offs[None, :]
        ops_x = torch.gather(trace_op, 1, torch.clamp(pos, max=L - 1)
                             .to(i64)).to(torch.int32)
        plain = (pos < L) & (ops_x <= Op.MFENCE) & (ops_x != Op.BRANCH)
        cycles_x = cost_table[torch.clamp(ops_x, 0, 19).to(i64)]
        cost_x = nn_ceil_div(cycles_x * 1_000_000,
                             freq_new.to(i64)[:, None])
        cost_x = torch.where(en_post, cost_x, 0)
        cum_before = clock[:, None] + torch.cumsum(cost_x, dim=1) - cost_x
        commit_x = plain & (cum_before < qend) & advance[:, None]
        commit_x = torch.cumprod(commit_x.to(torch.int32), dim=1) > 0
        extra_n = commit_x.sum(dim=1).to(torch.int32)
        extra_charged = torch.where(en_post, extra_n, 0)
        extra_cost = torch.where(commit_x, cost_x, 0).sum(dim=1)
        clock = clock + extra_cost
    else:
        extra_n = torch.zeros_like(core.idx)
        extra_charged = extra_n
        extra_cost = torch.zeros_like(clock)

    def wait(flag, t):
        return torch.where(flag, torch.clamp(t - clock0, min=0), 0)

    recv_wait = wait(ln.recv_now, ln.recv_time)
    barrier_wait = wait(ln.released, ln.release_time)
    bsync_wait = wait(ln.bsync_now, ln.bsync_time)
    cjoin_wait = wait(ln.cjoin_now, ln.cjoin_time)
    instr_now = advance & (is_static | is_branch | dyn_plain)
    recv_charged = ln.recv_now & (recv_wait > 0) & enabled
    sync_charged = (ln.released & (barrier_wait > 0)
                    | ln.granted & (ln.mutex_wait_ps > 0)
                    | (ln.bsync_now & (bsync_wait > 0))
                    | (ln.cjoin_now & (cjoin_wait > 0))) & enabled

    taken = ((ln.flags & FLAG_BRANCH_TAKEN) != 0).to(torch.uint8)
    bp_write = active & is_branch & enabled
    bp_ok = ln.bp_pred == taken

    core.clock_ps.copy_(clock)
    core.freq_mhz.copy_(freq_new)
    core.idx.add_(advance.to(torch.int32) + extra_n)
    core.instruction_count.add_(
        (instr_now & enabled).to(i64) + extra_charged.to(i64)
        + torch.where(advance & is_bblock & enabled, ln.aux0.to(i64), 0)
        + recv_charged.to(i64) + sync_charged.to(i64))
    core.execution_stall_ps.add_(
        extra_cost + torch.where(advance & (simple_instr | is_bblock), cost,
                                 0))
    if req is not None or ioc_tile is not None:
        core.memory_stall_ps.add_(
            torch.where(advance & (simple_instr | is_bblock), mem_acc, 0))
    if ioc_tile is not None:
        core.memory_stall_ps.add_(ln.ioc_mem_stall)
        core.execution_stall_ps.add_(ln.ioc_exec_stall)
    core.recv_instructions.add_(recv_charged.to(i64))
    core.recv_stall_ps.add_(torch.where(recv_charged, recv_wait, 0))
    core.sync_instructions.add_(sync_charged.to(i64))
    core.sync_stall_ps.add_(
        torch.where(ln.released & enabled, barrier_wait, 0)
        + torch.where(ln.granted & enabled, ln.mutex_wait_ps, 0)
        + torch.where(enabled, bsync_wait + cjoin_wait, 0))
    rows = torch.arange(T, device=op.device)
    cols = ln.bp_index.to(i64)
    core.bp_bits[rows, cols] = torch.where(bp_write, taken,
                                           core.bp_bits[rows, cols])
    core.bp_correct.add_((bp_write & bp_ok).to(i64))
    core.bp_incorrect.add_((bp_write & ~bp_ok).to(i64))
    net.packets_sent.add_((active & is_send).to(i64))
    net.packets_received.add_(ln.recv_now.to(i64))
    net.total_latency_ps.add_(
        torch.where(ln.recv_now, ln.recv_lat.to(i64), 0))
    done.copy_(ln.done)
    ln.progress.add_(advance.sum(dtype=torch.int32))
    if req is not None:
        # a committed record's slot machinery restarts at the next one
        req.slot.copy_(torch.where(advance, 0, req.slot))
        req.acc_ps.copy_(torch.where(advance, 0, req.acc_ps))
        req.slot_lat_ps.copy_(torch.where(advance[:, None], 0,
                                          req.slot_lat_ps))
    if p2p_round is not None:
        p2p_round.copy_(((p2p_round.to(i64) + 1 + 2**31) % 2**32
                         - 2**31).to(torch.int32))


def lane_commit(trace_op: torch.Tensor, lanes: Lanes,
                freq_new: torch.Tensor, en_post: torch.Tensor,
                core: CoreState, net: UserNetState,
                done: torch.Tensor, enabled: torch.Tensor,
                qend: torch.Tensor, cost_table: torch.Tensor, *,
                n_follow: int, req=None, ioc_tile=None,
                p2p_round=None) -> None:
    """Commit one iteration in place: `core`, `net`'s counters, `done`,
    and `lanes.progress` (+= lanes advanced).  `freq_new` is the post-
    DVFS_SET core frequency, `en_post` the post-event models-enabled
    flag, `n_follow` the number of follow-on PLAIN records a lane may
    batch (0 = off).  With a memory subsystem `req` is its
    RequesterState (records with memory slots wait for `lanes.mem_ok`,
    pay `req.acc_ps`, and a committed record resets the slot machinery);
    with the iocoom core `ioc_tile` marks its tiles (their instruction
    records take `lanes.ioc_clock` and the iocoom stall increments); under
    `lax_p2p` `p2p_round` (int32[]) goes up by one."""
    if done.device.type == "cpu":
        lane_commit_plain(trace_op, lanes, freq_new, en_post, core, net,
                          done, enabled, qend, cost_table, n_follow,
                          req=req, ioc_tile=ioc_tile, p2p_round=p2p_round)
        return
    if done.device.type != "cuda":
        raise ValueError(f"lane_commit: unsupported device {done.device}")
    KERNEL.launch_bound(*bound_args(trace_op, lanes, freq_new, en_post,
                                    core, net, done, enabled, qend,
                                    cost_table, n_follow, req, ioc_tile,
                                    p2p_round))


def bound_args(trace_op, lanes, freq_new, en_post, core, net, done,
               enabled, qend, cost_table, n_follow, req=None,
               ioc_tile=None, p2p_round=None) -> tuple:
    """The (tensors, key) a call binds, in `CommitArgs` order."""
    mem = req is not None
    ioc = ioc_tile is not None
    return ((trace_op, *_lane_get(lanes), freq_new, en_post, lanes.progress,
             *_core_get(core), core.bp_bits, *_net_get(net), done, enabled,
             qend, cost_table, p2p_round,
             lanes.mem_ok if mem else None, req.slot if mem else None,
             req.acc_ps if mem else None, req.slot_lat_ps if mem else None,
             ioc_tile, lanes.ioc_clock if ioc else None,
             lanes.ioc_mem_stall if ioc else None,
             lanes.ioc_exec_stall if ioc else None,
             core.memory_stall_ps if mem or ioc else None),
            (int(n_follow),))
