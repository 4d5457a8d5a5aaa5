"""`mem_requester_fill`: phase 6 of the memory engine, the requesters
consuming their replies, and the engine's completion signal.

Replaces `_requester_fill` (`graphite_tpu/memory/engine.py:2547-2712`)
and the completion signal of `memory_engine_step` (`:1823-1825`).
Kernel: `csrc/mem_requester_fill.cu`, one CTA, one lane a thread,
launched through a binding (`build.Kernel.launch_bound`).

Per lane waiting with a reply in its cell: pick the L2 victim of the
line's set; a valid victim needs the (victim's home, lane) eviction cell
free, else the fill waits an iteration.  The fill inserts the line in
the L2 (MODIFIED for EX_REP, else SHARED) and in the L1 the request came
from, sends the victim's eviction (FLUSH_REP if dirty), clears the
cached-location of an L1 victim, updates the miss-type sets and the line
utilization, completes the slot (latency measured from the record's
base clock), applies the functional store, and frees the reply cell.
Last, `mem_ok` = requester idle and no slot of the record left.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    mt_same_bucket, mt_test, mt_update, next_present_slot, slots_present,
    util_classify,
)
from graphite_tpu_torch.memory.context import (
    CYC_L1D_DAT, CYC_L1I_DAT, CYC_L2_DAT, CYC_SYNC_L2_NET, MemCtx, MemRec,
)
from graphite_tpu_torch.memory.state import (
    MOD_L1D, MOD_L1I, MSG_EX_REP, MSG_FLUSH_REP, MSG_INV_REP, MSG_NONE,
    MT_EVICTED, MT_FETCHED, MT_INVALIDATED, PHASE_IDLE, PHASE_WAIT_REPLY,
    MemState,
)
from graphite_tpu_torch.ops.build import Kernel, check_width
from graphite_tpu_torch.ops.mem_net_route import net_tensors, pack_with_net
from graphite_tpu_torch.ops.mem_requester import (
    MAX_TILES, apply_functional, cache_specs, cache_tensors, engine_values,
)

_REQ = (("phase", torch.int32), ("slot", torch.int32),
        ("acc_ps", torch.int64), ("line", torch.int32),
        ("is_write", torch.bool), ("component", torch.uint8))
_COUNTERS = ("evictions", "line_util_reads", "line_util_writes",
             "line_util_hist")


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`FillArgs` in
    csrc/mem_requester_fill.cu: the pointers, then `MemConsts`)."""
    ctx, L = key
    mp = ctx.mp
    T = mp.n_tiles
    check_width("mem_requester_fill", T, MAX_TILES, "tiles")
    i64, i32, b, u8 = torch.int64, torch.int32, torch.bool, torch.uint8
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.flags", i32, t),
             ("lanes.aux0", i32, t), ("lanes.aux1", i32, t),
             ("trace.addr0", i64, (T, L)), ("trace.addr1", i64, (T, L)),
             ("core.idx", i32, t), ("core.clock_ps", i64, t),
             ("core.freq_mhz", i32, t), ("enabled", b, ()),
             ("progress", i32, (1,)), ("mem_ok", b, t)]
    specs += cache_specs(ctx)
    specs += [("mail.evict_type", u8, (T, T)),
              ("mail.evict_line", i32, (T, T)),
              ("mail.evict_time", i64, (T, T)),
              ("mail.rep_type", u8, t), ("mail.rep_time", i64, t)]
    specs += [(f"req.{n}", dt, t) for n, dt in _REQ]
    specs += [("req.slot_lat_ps", i64, (T, 3))]
    specs += [(f"counters.{n}", i64, (T, 8) if n == "line_util_hist" else t)
              for n in _COUNTERS]
    specs += [("func_mem", i64, (max(mp.func_mem_words, 1) + 1,)),
              ("func_errors", i64, ())]
    return pack_with_net(tensors, specs, (L,) + engine_values(ctx),
                         mp.net_hbh, mp.net_atac, T)


KERNEL = Kernel("mem_requester_fill", "gt_mem_requester_fill", pack=_pack)


def bound_args(ctx: MemCtx, ms: MemState, lanes, trace, core, enabled,
               progress, mem_ok) -> tuple:
    """The (tensors, key) a call binds, in `FillArgs` order."""
    mail, req, cnt = ms.mail, ms.req, ms.counters
    return ((lanes.op, lanes.flags, lanes.aux0, lanes.aux1, trace.addr0,
             trace.addr1, core.idx, core.clock_ps, core.freq_mhz, enabled,
             progress, mem_ok, *cache_tensors(ctx, ms), mail.evict_type,
             mail.evict_line, mail.evict_time, mail.rep_type, mail.rep_time,
             *(getattr(req, n) for n, _ in _REQ), req.slot_lat_ps,
             *(getattr(cnt, n) for n in _COUNTERS), ms.func_mem,
             ms.func_errors, *net_tensors(ctx.mp, ms.noc)),
            (ctx, trace.addr0.shape[1]))


def mem_requester_fill_plain(ctx: MemCtx, ms: MemState, rec: MemRec, clock,
                             fmhz, enabled, progress, mem_ok) -> None:
    mp = ctx.mp
    dev = clock.device
    tiles = ctx.tiles
    i64 = torch.int64
    req, mail = ms.req, ms.mail
    cps = ctx.cycle_ps(fmhz, enabled)

    have_rep = (req.phase == PHASE_WAIT_REPLY) & (mail.rep_type != MSG_NONE)
    line = req.line
    comp_l1i = req.component == MOD_L1I
    l2_r = ca.gather_row(ms.l2.meta, line, ctx.l2_sets)
    l1i_r = ca.gather_row(ms.l1i.meta, line, ctx.l1i_sets)
    l1d_r = ca.gather_row(ms.l1d.meta, line, ctx.l1d_sets)
    if mp.l2.track_miss_types:
        e_bit = mt_test(ms.mt, MT_EVICTED, line)
        i_bit = mt_test(ms.mt, MT_INVALIDATED, line)
    if mp.l2.track_line_utilization:
        lu_row = ms.l2_util[tiles, l2_r.sets]

    # the L2 victim; a valid one needs its (home, us) eviction cell free
    way, v_valid, v_line, v_state = ca.row_pick_victim(
        l2_r, mp.l2.replacement, ctx.l2_ways)
    v_home = ctx.home_of_floor(v_line)
    need_evict = have_rep & v_valid
    evict_busy = mail.evict_type[v_home, tiles] != MSG_NONE
    fill = have_rep & ~(need_evict & evict_busy)
    evict_go = need_evict & fill

    new_state = torch.where(mail.rep_type == MSG_EX_REP, ca.MODIFIED,
                            ca.SHARED)
    ca.scatter_row(ms.l2.meta, ca.row_insert(l2_r, line, way, new_state,
                                             fill))
    if mp.l2.track_line_utilization:
        # the victim leaves (classified); the filled line starts with the
        # miss access itself
        lu_cur = torch.gather(lu_row, 1, way[:, None])[:, 0]
        init = torch.where(req.is_write, 1 << 16, 1)
        ms.l2_util[tiles, l2_r.sets, way] = torch.where(
            fill & enabled, init, lu_cur)
        util_classify(ms.counters, lu_cur, evict_go, enabled)
    cloc = ms.l2_cloc
    cloc[tiles, l2_r.sets, way] = torch.where(
        fill, torch.where(comp_l1i, MOD_L1I, MOD_L1D).to(torch.uint8),
        cloc[tiles, l2_r.sets, way])

    v_dirty = (v_state == ca.MODIFIED) | (v_state == ca.OWNED)
    e_msg = torch.where(v_dirty, MSG_FLUSH_REP, MSG_INV_REP)
    # reply arrival + net sync + L2 insert, then the L1 pass
    fill_l2_ps = (mail.rep_time + cps[:, CYC_SYNC_L2_NET]
                  + cps[:, CYC_L2_DAT])
    done_ps = fill_l2_ps + torch.where(comp_l1i, cps[:, CYC_L1I_DAT],
                                       cps[:, CYC_L1D_DAT])
    e_arrival = net.send(ctx, ms, tiles, v_home, v_dirty, fill_l2_ps,
                         evict_go, enabled, plain=True)
    for arr, val in ((mail.evict_type, e_msg), (mail.evict_line, v_line),
                     (mail.evict_time, e_arrival)):
        arr[v_home, tiles] = torch.where(evict_go, val, arr[v_home, tiles]
                                         ).to(arr.dtype)
    mail.rep_type.copy_(torch.where(fill, MSG_NONE, mail.rep_type))
    mail.rep_time.copy_(torch.where(fill, 0, mail.rep_time))

    # the L1 fill
    l1i_way, l1i_vv, l1i_vline, _ = ca.row_pick_victim(
        l1i_r, mp.l1i.replacement, ctx.l1i_ways)
    l1d_way, l1d_vv, l1d_vline, _ = ca.row_pick_victim(
        l1d_r, mp.l1d.replacement, ctx.l1d_ways)
    ca.scatter_row(ms.l1i.meta, ca.row_insert(l1i_r, line, l1i_way,
                                              new_state, fill & comp_l1i))
    ca.scatter_row(ms.l1d.meta, ca.row_insert(l1d_r, line, l1d_way,
                                              new_state, fill & ~comp_l1i))
    # an L1 victim's cached-location, looked up in the updated L2
    l1_ev = (fill & comp_l1i & l1i_vv) | (fill & ~comp_l1i & l1d_vv)
    l1_ev_line = torch.where(comp_l1i, l1i_vline, l1d_vline)
    ev_hit, ev_way, _ = ca.lookup(ms.l2.meta, l1_ev_line, ctx.l2_sets)
    ev_sets = ca.set_index(l1_ev_line, ctx.l2_sets, nonneg=False)
    cloc[tiles, ev_sets, ev_way] = torch.where(
        l1_ev & ev_hit, 0, cloc[tiles, ev_sets, ev_way])

    if mp.l2.track_miss_types:
        mt_update(ms.mt, MT_EVICTED, v_line, evict_go, True)
        # the inserted line leaves exactly one set (evicted, else
        # invalidated), then joins the fetched set; the victim's EVICTED
        # bit just written counts when it shares the line's bucket
        e_in = e_bit | (evict_go & mt_same_bucket(v_line, line))
        mt_update(ms.mt, MT_EVICTED, line, fill & e_in, False)
        mt_update(ms.mt, MT_INVALIDATED, line, fill & ~e_in & i_bit, False)
        mt_update(ms.mt, MT_FETCHED, line, fill, True)

    old_slot = req.slot.clone()
    k = torch.arange(3, device=dev)[None, :]
    lat = done_ps - clock
    req.phase.copy_(torch.where(fill, PHASE_IDLE, req.phase))
    req.slot.copy_(torch.where(fill, old_slot + 1, old_slot))
    req.acc_ps.add_(torch.where(fill, lat, 0))
    req.slot_lat_ps.copy_(torch.where(
        fill[:, None] & (k == old_slot[:, None]), lat[:, None],
        req.slot_lat_ps))
    s_addr = torch.where(old_slot == 1, rec.addr0, rec.addr1)
    apply_functional(ctx, ms, rec, old_slot, s_addr, req.is_write, fill)
    ms.counters.evictions.add_((evict_go & enabled).to(i64))
    progress.add_(torch.sum(fill, dtype=torch.int32))

    present = slots_present(mp, rec.op, rec.flags, enabled)
    mem_ok.copy_((req.phase == PHASE_IDLE)
                 & (next_present_slot(present, req.slot) >= 3))


def mem_requester_fill(ctx: MemCtx, ms: MemState, lanes, trace, core,
                       enabled, progress, mem_ok, *,
                       rec: "MemRec | None" = None) -> None:
    """Phase 6 in place on `ms`; adds its events to `progress` and writes
    `mem_ok`."""
    dev = core.clock_ps.device
    if dev.type == "cpu":
        if rec is None:
            rec = MemRec.fetch(lanes, trace, core.idx)
        mem_requester_fill_plain(ctx, ms, rec, core.clock_ps,
                                 core.freq_mhz.to(torch.int64), enabled,
                                 progress, mem_ok)
        return
    if dev.type != "cuda":
        raise ValueError(f"mem_requester_fill: unsupported device {dev}")
    KERNEL.launch_bound(*bound_args(ctx, ms, lanes, trace, core, enabled,
                                    progress, mem_ok))
