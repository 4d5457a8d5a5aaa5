"""The subquantum step: every tile advances (at most) one trace record.

Port of `graphite_tpu/engine/step.py` `subquantum_iteration` (`:151-1204`)
for the simple and iocoom cores, with or without the private-L1/L2 MSI
memory subsystem, under any of the three clock-skew schemes (the
`lax_p2p` hold is part of `lane_fetch_cost`'s active latch, and
`lane_commit` advances its round counter).  The JAX step is one pure
function; here it is a fixed sequence of units over one `Lanes` scratch,
and the state is updated IN PLACE where JAX carried a buffer through the
loop (mailbox rings, barrier tables, core counters, memory state):

    lane_fetch_cost   kernel   fetch + done/active (+ the lax_p2p
                               hold) + cost                     (:193-403)
    memory engine     3 kernels + PyTorch, six phases           (:279-340)
    noc_route or      kernel   the sends through a contention   (:414-431)
      atac_route               USER net (emesh_hop_by_hop, atac)
    user_mailbox      kernel   sends, then receives             (:413-502)
    barrier_sync      kernel   init/arrive/release/split forms  (:505-577)
    mutex + cond      PyTorch                                   (:578-777)
    pub + COND_JOIN   PyTorch                                   (:779-820)
    join              PyTorch                                   (:822-840)
    DVFS_SET          PyTorch                                   (:916-998)
    models toggle     PyTorch  post-event enable flag          (:1041,1172)
    iocoom_commit     kernel   the iocoom pipeline algebra      (:856-900)
    lane_commit       kernel   advance/clock/counters/batching  (:842-1204)

The memory engine reads the pre-commit clock and frequency and the
fetched record, and nothing the machinery units write, so running it
first (as the JAX step does) or in any place before `iocoom_commit` is
the same.  `iocoom_commit` needs each lane's advance mask before
`lane_commit` computes it; for an instruction record that mask is
`active & mem_ok` (every other advance term belongs to another op).

Unit gating.  The JAX step skips each machinery block under a `lax.cond`
on "some lane has such an op now"; reading such a flag to the host every
iteration would cost a device sync.  Instead `Simulator` computes, once,
the set of op codes the trace contains, and `EngineParams.units` names
the units that can ever run; the rest are skipped.  That is bit-exact
because each block is the identity when none of its ops occurs (the
barrier/net/pub/join/DVFS blocks are also the identity whenever their
JAX gate is false, so they run ungated, masked per lane).  The
mutex+cond block is NOT the identity under a false gate — a pending
signal can be dropped as lost while no lane sits at a cond op — so that
unit evaluates the JAX gate on the device and blends its outputs with it
(no host read).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphite_tpu_torch.engine.state import (
    FAR_FUTURE_PS, GEN_RING, DeviceTrace, Lanes, SimState,
)
from graphite_tpu_torch.models.network_user import UserNetworkParams
from graphite_tpu_torch.ops import (
    atac_route, barrier_sync, iocoom_commit, lane_commit, lane_fetch_cost,
    noc_route, user_mailbox,
)
from graphite_tpu_torch.ops.barrier_sync import elect_min
from graphite_tpu_torch.trace.schema import Op

# measured-safe plain-run batching ceiling of the JAX engine
# (`step.py:68`); the port clamps to the same value so results agree
PLAIN_UNROLL_MAX = 16
BIG = 2**62

# unit name -> the op codes whose presence in a trace makes it run
UNIT_OPS = {
    "net": (Op.SEND, Op.NET_RECV),
    "barrier": (Op.BARRIER_INIT, Op.BARRIER_WAIT, Op.BARRIER_ARRIVE,
                Op.BARRIER_SYNC),
    "mutex": (Op.MUTEX_INIT, Op.MUTEX_LOCK, Op.MUTEX_UNLOCK, Op.COND_INIT,
              Op.COND_WAIT, Op.COND_SIGNAL, Op.COND_BROADCAST),
    "pub": (Op.COND_SIGNAL, Op.COND_BROADCAST, Op.COND_JOIN),
    "join": (Op.THREAD_JOIN,),
    "dvfs": (Op.DVFS_SET,),
    "models": (Op.ENABLE_MODELS, Op.DISABLE_MODELS),
}
ALL_UNITS = frozenset(UNIT_OPS)


def units_for_ops(present_ops) -> frozenset:
    """The units whose ops occur in a trace's op-code set."""
    present = {int(o) for o in present_ops}
    return frozenset(u for u, ops in UNIT_OPS.items()
                     if any(int(o) in present for o in ops))


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Static parameters of the step (`graphite_tpu/engine/step.py:72`),
    for the paths this package supports."""

    n_tiles: int
    static_cost_cycles: tuple  # 20 ints (`carbon_sim.cfg:189-200`)
    # the mailbox's network: the zero-load model, or kind "routed" under
    # a contention net (then `user_hbh` or `user_atac` routes each send)
    net: UserNetworkParams
    bp_enabled: bool = True
    bp_size: int = 1024
    bp_mispredict_penalty: int = 14
    mailbox_depth: int = 8
    inner_block: int = 32
    n_conds: int = 64
    syscall_rt_ps: int = 2000
    dvfs: "object" = None      # DvfsParams
    plain_unroll: int = 1
    # the machinery units that can run on this trace (see module doc)
    units: frozenset = ALL_UNITS
    # the memory subsystem (memory.params.MemParams; None = memoryless)
    mem: "object" = None
    # the iocoom core (models.iocoom.IocoomParams; None = simple core),
    # and which tiles run it (None = all, when set)
    iocoom: "object" = None
    iocoom_tiles: "tuple | None" = None
    # the USER net's contention model (models.network_hop_by_hop.
    # HopByHopParams or models.network_atac.AtacParams; None for both
    # under magic / emesh_hop_counter)
    user_hbh: "object" = None
    user_atac: "object" = None
    # the lax_p2p scheme's slack in ps (None under lax / lax_barrier)
    p2p_slack_ps: "int | None" = None

    def n_follow(self, trace_length: int) -> int:
        """Follow-on PLAIN records a lane may commit per iteration (the
        simple-core memoryless runs only, as in the JAX step; never under
        lax_p2p, whose hold is per iteration, `step.py:1009-1013`)."""
        if (self.plain_unroll <= 1 or trace_length <= 1
                or self.mem is not None or self.iocoom is not None
                or self.p2p_slack_ps is not None):
            return 0
        return min(self.plain_unroll - 1, PLAIN_UNROLL_MAX - 1,
                   trace_length - 1)


def mutex_cond_unit(params: EngineParams, state: SimState,
                     lanes: Lanes) -> None:
    """`_mutex_cond_block` (`step.py:590-777`) in PyTorch, blended with
    the JAX block's gate predicate (`:773-776`) evaluated on the device."""
    sync, clock = state.sync, state.core.clock_ps
    T = clock.shape[0]
    NM = sync.mutex_locked.shape[0]
    NC = params.n_conds
    K = sync.cond_sig_time_ps.shape[1]
    i32, i64 = torch.int32, torch.int64
    dev = clock.device
    tiles = torch.arange(T, dtype=i64, device=dev)
    op, aux0, aux1 = lanes.op, lanes.aux0, lanes.aux1
    active, done = lanes.active, lanes.done
    is_cwait = op == Op.COND_WAIT
    is_csig = op == Op.COND_SIGNAL
    is_cbcast = op == Op.COND_BROADCAST
    is_cinit = op == Op.COND_INIT
    is_minit = op == Op.MUTEX_INIT
    is_mlock = op == Op.MUTEX_LOCK
    is_munlock = op == Op.MUTEX_UNLOCK

    pred = torch.any(
        (active & (is_minit | is_munlock | is_csig | is_cbcast | is_cinit))
        | (is_mlock & ~done & (sync.mutex_waiting | active))
        | (is_cwait & ~done))

    mux = torch.clamp(aux0, 0, NM - 1).to(i64)
    cw_mux = torch.clamp(aux1, 0, NM - 1).to(i64)
    cid = torch.clamp(aux0, 0, NC - 1).to(i64)
    minit_now = active & is_minit
    mutex_locked = sync.mutex_locked.scatter_add(0, mux, torch.where(
        minit_now, -sync.mutex_locked[mux], 0).to(i32))
    cwait_arrive = (active & is_cwait & ~sync.cond_waiting
                    & ~sync.cond_signaled)
    cond_waiting = sync.cond_waiting | cwait_arrive
    cond_arrival = torch.where(cwait_arrive, clock, sync.cond_arrival_ps)

    # signal/broadcast posting into per-cond pending slots
    psig = sync.cond_sig_time_ps
    pbc = sync.cond_bcast_time_ps
    cinit_now = active & is_cinit
    init_cond = torch.zeros(NC, dtype=i32, device=dev).scatter_reduce(
        0, cid, cinit_now.to(i32), "amax", include_self=True) > 0
    psig = torch.where(init_cond[:, None], BIG, psig)
    pbc = torch.where(init_cond, BIG, pbc)
    sig_now = active & is_csig & (aux1 <= 0)
    bcast_now = active & is_cbcast & (aux1 <= 0)
    post_key = clock * T + tiles
    sbest = elect_min(sig_now, cid, post_key, NC)
    sig_elect = sig_now & (post_key == sbest[cid])
    free = psig >= FAR_FUTURE_PS
    have_free = free.any(dim=1)
    free_k = torch.argmax(free.to(i32), dim=1)
    sig_post = sig_elect & have_free[cid]
    psig = psig.reshape(-1).scatter_reduce(
        0, cid * K + free_k[cid], torch.where(sig_post, clock, BIG),
        "amin", include_self=True).reshape(NC, K)
    bbest = elect_min(bcast_now, cid, post_key, NC)
    bc_elect = bcast_now & (post_key == bbest[cid])
    bc_post = bc_elect & (pbc[cid] >= FAR_FUTURE_PS)
    pbc = pbc.scatter_reduce(0, cid, torch.where(bc_post, clock, BIG),
                             "amin", include_self=True)

    # delivery / drop, in simulated-time order
    runner = ~done & ~cond_waiting & ~sync.cond_signaled
    min_active = torch.where(runner, clock, BIG).min()
    S = psig.min(dim=1).values
    s_k = torch.argmin(psig, dim=1)
    bc_time = pbc
    have_sig = (S < FAR_FUTURE_PS) & (S < bc_time)
    bc_first = (bc_time < FAR_FUTURE_PS) & (bc_time <= S)
    elig = cond_waiting & (cond_arrival <= S[cid])
    wake_key = cond_arrival * T + tiles
    ckey = torch.where(elig, wake_key, BIG)
    cbest = elect_min(elig, cid, ckey, NC)
    any_elig = cbest < BIG
    best_arrival = torch.div(cbest, T, rounding_mode="floor")
    safe_deliver = have_sig & any_elig & (best_arrival <= min_active)
    lost = have_sig & ~any_elig & (min_active >= S)
    woken_s = elig & safe_deliver[cid] & (ckey == cbest[cid])
    clear_slot = safe_deliver | lost
    psig = psig.reshape(-1).scatter_reduce(
        0, torch.arange(NC, device=dev) * K + s_k,
        torch.where(clear_slot, BIG, 0), "amax",
        include_self=True).reshape(NC, K)
    bc_ready = bc_first & (min_active >= bc_time)
    woken_b = (cond_waiting & bc_ready[cid]
               & (cond_arrival <= bc_time[cid]) & ~woken_s)
    pbc = torch.where(bc_ready, BIG, pbc)
    woken = woken_b | woken_s
    cond_wake = torch.where(woken_b, bc_time[cid],
                            torch.where(woken_s, S[cid], sync.cond_wake_ps))
    cond_signaled = sync.cond_signaled | woken
    cond_waiting = cond_waiting & ~woken

    # lock candidates: MUTEX_LOCK lanes + signaled COND_WAIT re-lockers
    relock = is_cwait & ~done & cond_signaled
    plain_lock = is_mlock & ~done & (sync.mutex_waiting | active)
    lock_candidate = plain_lock | relock
    lmux = torch.where(relock, cw_mux, mux)
    eff_clock = torch.where(relock, torch.maximum(clock, cond_wake), clock)
    grant_key = eff_clock * T + tiles
    best_key = elect_min(lock_candidate, lmux, grant_key, NM)
    grantable = mutex_locked == 0
    cur_blocking = (
        (op == Op.NET_RECV) | (op == Op.THREAD_JOIN)
        | (op == Op.BARRIER_WAIT) | is_mlock | is_cwait
        | (op == Op.BARRIER_SYNC) | (op == Op.COND_JOIN))
    advancing = ~done & ~cur_blocking
    min_adv_key = torch.where(advancing, clock * T, BIG).min()
    free_cand_min = torch.where(lock_candidate & grantable[lmux], grant_key,
                                BIG).min()
    granted = (lock_candidate & grantable[lmux]
               & (grant_key == best_key[lmux])
               & (grant_key == free_cand_min)
               & (grant_key <= min_adv_key))
    grab = sync.mutex_time_ps[lmux]
    wait_until = torch.where(relock, torch.maximum(grab, cond_wake), grab)
    mutex_wait = torch.where(granted,
                             torch.clamp(wait_until - clock, min=0), 0)
    mutex_locked = mutex_locked.scatter_add(0, lmux, granted.to(i32))
    mutex_owner = sync.mutex_owner.scatter_add(0, lmux, torch.where(
        granted, tiles.to(i32) - sync.mutex_owner[lmux], 0).to(i32))
    mutex_waiting = (plain_lock & ~granted) | (sync.mutex_waiting
                                               & ~is_mlock)
    cond_signaled = cond_signaled & ~granted
    un_do = (active & is_munlock) | cwait_arrive
    un_mux = torch.where(cwait_arrive, cw_mux, mux)
    mutex_locked = mutex_locked.scatter_add(
        0, un_mux, torch.where(un_do, -1, 0).to(i32))
    mutex_owner = mutex_owner.scatter_add(0, un_mux, torch.where(
        un_do, -1 - mutex_owner[un_mux], 0).to(i32))
    mutex_time = sync.mutex_time_ps.scatter_add(0, un_mux, torch.where(
        un_do, clock - sync.mutex_time_ps[un_mux], 0))

    def keep(new, old):
        return torch.where(pred, new, old)

    sync.mutex_locked = keep(mutex_locked, sync.mutex_locked)
    sync.mutex_owner = keep(mutex_owner, sync.mutex_owner)
    sync.mutex_time_ps = keep(mutex_time, sync.mutex_time_ps)
    sync.mutex_waiting = keep(mutex_waiting, sync.mutex_waiting)
    sync.cond_waiting = keep(cond_waiting, sync.cond_waiting)
    sync.cond_signaled = keep(cond_signaled, sync.cond_signaled)
    sync.cond_arrival_ps = keep(cond_arrival, sync.cond_arrival_ps)
    sync.cond_wake_ps = keep(cond_wake, sync.cond_wake_ps)
    sync.cond_sig_time_ps = keep(psig, sync.cond_sig_time_ps)
    sync.cond_bcast_time_ps = keep(pbc, sync.cond_bcast_time_ps)
    lanes.granted.copy_(granted & pred)
    lanes.mutex_wait_ps.copy_(keep(mutex_wait, 0))
    lanes.cond_post_commit.copy_((sig_post | bc_post) & pred)


def pub_unit(params: EngineParams, state: SimState, lanes: Lanes) -> None:
    """Published cond signals + COND_JOIN (`step.py:793-820`)."""
    sync, clock = state.sync, state.core.clock_ps
    NC = params.n_conds
    i64 = torch.int64
    op, aux1, active = lanes.op, lanes.aux1, lanes.active
    pub_now = active & ((op == Op.COND_SIGNAL) | (op == Op.COND_BROADCAST)) \
        & (aux1 > 0)
    cid = torch.clamp(lanes.aux0, 0, NC - 1).to(i64)
    seq = sync.cond_sig_seq.scatter_add(
        0, torch.where(pub_now, cid, 0),
        pub_now.to(torch.int32))
    slot = torch.fmod(seq[cid], GEN_RING).to(i64)
    flat = (torch.where(pub_now, cid, 0) * GEN_RING
            + torch.where(pub_now, slot, 0))
    seq_ps = sync.cond_sig_seq_ps.reshape(-1).scatter_reduce(
        0, flat, torch.where(pub_now, clock, 0), "amax",
        include_self=True).reshape(NC, GEN_RING)
    cjoin_now = active & (op == Op.COND_JOIN) & (seq[cid] >= aux1)
    cjoin_t = seq_ps[cid, torch.remainder(aux1, GEN_RING).to(i64)]
    sync.cond_sig_seq = seq
    sync.cond_sig_seq_ps = seq_ps
    lanes.pub_now.copy_(pub_now)
    lanes.cjoin_now.copy_(cjoin_now)
    lanes.cjoin_time.copy_(cjoin_t)


def join_unit(state: SimState, lanes: Lanes) -> None:
    """THREAD_JOIN (`step.py:822-840`): the target's liveness is read off
    its own fetched record and the PRE-iteration done flags."""
    T = lanes.op.shape[0]
    clock = state.core.clock_ps
    at_exit = lanes.op == Op.THREAD_EXIT
    target = torch.clamp(lanes.aux0, 0, T - 1).to(torch.int64)
    target_done = state.done[target] | at_exit[target]
    lanes.join_now.copy_(lanes.active & (lanes.op == Op.THREAD_JOIN)
                         & target_done)
    lanes.join_time.copy_(torch.maximum(clock, clock[target]))


def dvfs_unit(params: EngineParams, state: SimState, lanes: Lanes) -> None:
    """In-trace DVFS_SET validated against the V/f tables (`step.py:
    922-998`, the per-tile table path: no runtime DvfsSpec)."""
    dvp = params.dvfs
    dv = state.dvfs
    ND = dvp.n_domains
    dev = lanes.op.device
    i32 = torch.int32
    T = lanes.op.shape[0]
    aux0, aux1 = lanes.aux0, lanes.aux1
    req = torch.abs(aux1)
    hold = aux1 < 0
    dom = torch.clamp(aux0, 0, ND - 1).to(torch.int64)
    valid_dom = (aux0 >= 0) & (aux0 < ND)
    volts = torch.tensor(dvp.voltages_mv, dtype=i32, device=dev)
    maxf = torch.tensor(dvp.max_freq_mhz, dtype=i32, device=dev)
    NL = len(dvp.voltages_mv)
    ok_levels = req[:, None] <= maxf[None, :]
    freq_ok = ok_levels.any(dim=1) & (req > 0)
    lvl = (NL - 1) - torch.argmax(
        torch.flip(ok_levels, dims=[1]).to(i32), dim=1)
    auto_v = volts[torch.clamp(lvl, 0, NL - 1)]
    tiles = torch.arange(T, device=dev)
    cur_v = dv.voltage_mv[tiles, dom]
    cur_lvl = torch.argmax((volts[None, :] == cur_v[:, None]).to(i32), dim=1)
    hold_ok = req <= maxf[cur_lvl]
    attempt = lanes.active & (lanes.op == Op.DVFS_SET)
    valid = valid_dom & freq_ok & (~hold | hold_ok)
    ok = attempt & valid
    err = attempt & ~valid
    new_v = torch.where(hold, cur_v, auto_v)
    dmask = ((dom[:, None] == torch.arange(ND, device=dev)[None, :])
             & ok[:, None])
    dv.freq_mhz = torch.where(dmask, req[:, None], dv.freq_mhz)
    dv.voltage_mv = torch.where(dmask, new_v[:, None], dv.voltage_mv)
    dv.errors = dv.errors + err.to(torch.int64)
    core_set = ok & (dom == dvp.core_domain)
    lanes.freq_new.copy_(torch.where(core_set, req, state.core.freq_mhz))


def models_unit(state: SimState, lanes: Lanes) -> None:
    """ENABLE/DISABLE_MODELS: the post-event enable flag (`step.py:1041,
    1172-1176`); the commit charges follow-ons under it."""
    act, op = lanes.active, lanes.op
    disable_now = torch.any(act & (op == Op.DISABLE_MODELS))
    enable_now = torch.any(act & (op == Op.ENABLE_MODELS))
    lanes.en_post.copy_(torch.where(
        disable_now, False, torch.where(enable_now, True,
                                        state.models_enabled)))


@dataclasses.dataclass
class ModelCtx:
    """The per-run device tables of the memory subsystem and the iocoom
    core (None where the run has none)."""

    mem: "object" = None                   # memory.context.MemCtx
    ioc_tile: "torch.Tensor | None" = None  # bool[T]: the iocoom tiles


NO_MODELS = ModelCtx()


def subquantum_iteration(params: EngineParams, trace: DeviceTrace,
                         state: SimState, qend: torch.Tensor,
                         lanes: Lanes, cost_table: torch.Tensor,
                         models: ModelCtx = NO_MODELS) -> None:
    """One iteration, in place on `state`; adds the number of lanes that
    advanced, and the memory engine's events, to `lanes.progress` (the
    JAX step's second return value)."""
    core = state.core
    units = params.units
    p2p_round = None if params.p2p_slack_ps is None else state.p2p_round
    lane_fetch_cost(trace, core, state.done, state.models_enabled, qend,
                    cost_table, bp_enabled=params.bp_enabled,
                    bp_penalty=params.bp_mispredict_penalty,
                    syscall_rt_ps=params.syscall_rt_ps, lanes=lanes,
                    p2p_slack_ps=params.p2p_slack_ps, p2p_round=p2p_round)
    if params.mem is not None:
        if params.mem.is_shl2:
            from graphite_tpu_torch.memory.engine_shl2 import (
                shl2_engine_step as engine_step,
            )
        else:
            from graphite_tpu_torch.memory.engine import (
                memory_engine_step as engine_step,
            )
        engine_step(models.mem, state.mem, lanes, trace, core,
                    state.models_enabled, lanes.progress, lanes.mem_ok)
    if "net" in units:
        # a route call with no live sender is the identity on the queues
        # (the JAX net block's gate is only a skip)
        if params.user_hbh is not None:
            noc_route(params.user_hbh, state.noc_user, lanes, core.clock_ps,
                      state.models_enabled)
        elif params.user_atac is not None:
            atac_route(params.user_atac, state.noc_user, lanes,
                       core.clock_ps, state.models_enabled)
        user_mailbox(params.net, lanes, core.clock_ps, state.models_enabled,
                     state.net)
    if "barrier" in units:
        barrier_sync(lanes, core.clock_ps, state.sync)
    if "mutex" in units:
        mutex_cond_unit(params, state, lanes)
    if "pub" in units:
        pub_unit(params, state, lanes)
    if "join" in units:
        join_unit(state, lanes)
    freq_new = core.freq_mhz
    if "dvfs" in units:
        dvfs_unit(params, state, lanes)
        freq_new = lanes.freq_new
    en_post = state.models_enabled
    if "models" in units:
        models_unit(state, lanes)
        en_post = lanes.en_post
    req = state.mem.req if params.mem is not None else None
    if params.iocoom is not None:
        iocoom_commit(params.iocoom, state.ioc, lanes, models.ioc_tile, core,
                      trace, None if req is None else req.slot_lat_ps,
                      state.models_enabled)
    lane_commit(trace.op, lanes, freq_new, en_post, core, state.net,
                state.done, state.models_enabled, qend, cost_table,
                n_follow=params.n_follow(trace.length), req=req,
                ioc_tile=models.ioc_tile, p2p_round=p2p_round)
    if "models" in units:
        state.models_enabled.copy_(lanes.en_post)


def cost_table_tensor(params: EngineParams, device) -> torch.Tensor:
    return torch.tensor(np.asarray(params.static_cost_cycles, np.int64),
                        device=device)
