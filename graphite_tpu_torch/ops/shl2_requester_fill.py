"""`shl2_requester_fill`: phase 6 of the shared-L2 engine, the requesters
consuming their replies, and the engine's completion signal.

Replaces `_requester_fill` (`graphite_tpu/memory/engine_shl2.py:
1141-1230`) with `_apply_functional` (`:642-656`) and `mem_complete`
(`:622-623`).  Kernel: `csrc/shl2_requester_fill.cu`, one CTA, one lane
a thread, launched through a binding (`build.Kernel.launch_bound`).

Per lane waiting with a reply: the L1 fill (L1-I or L1-D, by the
request's component) in MODIFIED (EX_REP), EXCLUSIVE (MESI's EXCL_REP)
or SHARED; an upgrade reply lands in the line's own way, a miss takes
the victim way, and a valid victim is evicted to its home slice (FLUSH
when MODIFIED, else INV) when that home's eviction cell for this lane is
free, else the lane waits a whole iteration with its reply (the cells
are read before any lane writes one in this phase); then the slot
completes (latency, functional store).  Every lane's `mem_ok` is written
last.  The only state two lanes write is the functional store, as in
`mem_requester_fill`.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    ccycles, next_present_slot, slots_present,
)
from graphite_tpu_torch.memory.context import CYC_L1D_DAT, MemCtx, MemRec
from graphite_tpu_torch.memory.state import (
    MOD_L1D, MOD_L1I, MOD_NET_MEM, MSG_EX_REP, MSG_EXCL_REP, MSG_FLUSH_REP,
    MSG_INV_REP, MSG_NONE, PHASE_IDLE, PHASE_WAIT_REPLY, ShL2State,
)
from graphite_tpu_torch.ops.build import Kernel, check_width
from graphite_tpu_torch.ops.mem_net_route import net_tensors, pack_with_net
from graphite_tpu_torch.ops.mem_requester import (
    MAX_TILES, apply_functional, engine_values,
)
from graphite_tpu_torch.ops.shl2_requester import shl2_values

_REQ = (("phase", torch.int32), ("slot", torch.int32),
        ("acc_ps", torch.int64), ("line", torch.int32),
        ("is_write", torch.bool), ("component", torch.uint8))


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`Shl2FillArgs` in
    csrc/shl2_requester_fill.cu: the pointers, then the plain values)."""
    ctx, L = key
    mp = ctx.mp
    T = mp.n_tiles
    check_width("shl2_requester_fill", T, MAX_TILES, "tiles")
    i64, i32, b, u8 = torch.int64, torch.int32, torch.bool, torch.uint8
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.flags", i32, t),
             ("lanes.aux0", i32, t), ("lanes.aux1", i32, t),
             ("trace.addr0", i64, (T, L)), ("trace.addr1", i64, (T, L)),
             ("core.idx", i32, t), ("core.clock_ps", i64, t),
             ("core.freq_mhz", i32, t), ("enabled", b, ()),
             ("progress", i32, (1,)), ("mem_ok", b, t),
             ("ctx.cyc", i64, (T, 11)), ("ctx.sets", i32, (3, T)),
             ("ctx.ways", i32, (3, T)),
             ("l1i.meta", i64, (T, mp.l1i.num_sets, mp.l1i.num_ways)),
             ("l1d.meta", i64, (T, mp.l1d.num_sets, mp.l1d.num_ways)),
             ("mail.evict_type", u8, (T, T)),
             ("mail.evict_line", i32, (T, T)),
             ("mail.evict_time", i64, (T, T)),
             ("mail.rep_type", u8, t), ("mail.rep_time", i64, t)]
    specs += [(f"req.{n}", dt, t) for n, dt in _REQ]
    specs += [("req.slot_lat_ps", i64, (T, 3)),
              ("counters.evictions", i64, t),
              ("func_mem", i64, (max(mp.func_mem_words, 1) + 1,)),
              ("func_errors", i64, ())]
    return pack_with_net(tensors, specs,
                         (L,) + shl2_values(ctx) + engine_values(ctx),
                         mp.net_hbh, mp.net_atac, T)


KERNEL = Kernel("shl2_requester_fill", "gt_shl2_requester_fill",
                pack=_pack)


def bound_args(ctx: MemCtx, ms: ShL2State, lanes, trace, core, enabled,
               progress, mem_ok) -> tuple:
    """The (tensors, key) a call binds, in `Shl2FillArgs` order."""
    mail, req = ms.mail, ms.req
    return ((lanes.op, lanes.flags, lanes.aux0, lanes.aux1, trace.addr0,
             trace.addr1, core.idx, core.clock_ps, core.freq_mhz, enabled,
             progress, mem_ok, ctx.cyc, ctx.sets, ctx.ways, ms.l1i.meta,
             ms.l1d.meta, mail.evict_type, mail.evict_line, mail.evict_time,
             mail.rep_type, mail.rep_time,
             *(getattr(req, n) for n, _ in _REQ), req.slot_lat_ps,
             ms.counters.evictions, ms.func_mem, ms.func_errors,
             *net_tensors(ctx.mp, ms.noc)),
            (ctx, trace.addr0.shape[1]))


def shl2_requester_fill_plain(ctx: MemCtx, ms: ShL2State, rec: MemRec,
                              clock, fmhz, enabled, progress,
                              mem_ok) -> None:
    """Phase 6 in place on `ms`; adds its events to `progress` and writes
    `mem_ok`."""
    mp = ctx.mp
    T = mp.n_tiles
    tiles = ctx.tiles
    i64 = torch.int64
    req, mail = ms.req, ms.mail

    have_rep = (req.phase == PHASE_WAIT_REPLY) & (mail.rep_type != MSG_NONE)
    line = req.line
    comp_l1i = req.component == MOD_L1I
    new_state = torch.where(
        mail.rep_type == MSG_EX_REP, ca.MODIFIED,
        torch.where(mail.rep_type == MSG_EXCL_REP, ca.EXCLUSIVE, ca.SHARED))

    # an upgrade reply lands in the line's own way; a miss picks a victim
    l1i_r = ca.gather_row(ms.l1i.meta, line, ctx.l1i_sets)
    l1d_r = ca.gather_row(ms.l1d.meta, line, ctx.l1d_sets)
    l1i_hit, l1i_hway, _ = ca.row_lookup(l1i_r, line)
    l1d_hit, l1d_hway, _ = ca.row_lookup(l1d_r, line)
    l1i_vway, l1i_vv, l1i_vline, l1i_vstate = ca.row_pick_victim(
        l1i_r, mp.l1i.replacement, ctx.l1i_ways)
    l1d_vway, l1d_vv, l1d_vline, l1d_vstate = ca.row_pick_victim(
        l1d_r, mp.l1d.replacement, ctx.l1d_ways)
    l1i_way = torch.where(l1i_hit, l1i_hway, l1i_vway)
    l1d_way = torch.where(l1d_hit, l1d_hway, l1d_vway)
    already = torch.where(comp_l1i, l1i_hit, l1d_hit)
    v_valid = torch.where(comp_l1i, l1i_vv, l1d_vv) & ~already
    v_line = torch.where(comp_l1i, l1i_vline, l1d_vline)
    v_state = torch.where(comp_l1i, l1i_vstate, l1d_vstate)
    v_home = torch.remainder(v_line, T)
    need_evict = have_rep & v_valid
    # the victim's (home, us) eviction cell as it stood before the phase
    evict_busy = mail.evict_type[v_home, tiles] != MSG_NONE
    fill = have_rep & ~(need_evict & evict_busy)
    evict_go = need_evict & fill

    ca.scatter_row(ms.l1i.meta, ca.row_insert(l1i_r, line, l1i_way,
                                              new_state, fill & comp_l1i))
    ca.scatter_row(ms.l1d.meta, ca.row_insert(l1d_r, line, l1d_way,
                                              new_state, fill & ~comp_l1i))

    dirty = v_state == ca.MODIFIED
    e_msg = torch.where(dirty, MSG_FLUSH_REP, MSG_INV_REP)
    fill_ps = (mail.rep_time
               + ccycles(mp.sync_cycles(MOD_L1D, MOD_NET_MEM), fmhz, enabled)
               + ctx.cycle_ps(fmhz, enabled)[:, CYC_L1D_DAT])
    arrival = net.send(ctx, ms, tiles, v_home, dirty, fill_ps, evict_go,
                       enabled, plain=True)
    for arr, val in ((mail.evict_type, e_msg), (mail.evict_line, v_line),
                     (mail.evict_time, arrival)):
        arr[v_home, tiles] = torch.where(evict_go, val, arr[v_home, tiles]
                                         ).to(arr.dtype)
    mail.rep_type.copy_(torch.where(fill, MSG_NONE, mail.rep_type))
    mail.rep_time.copy_(torch.where(fill, 0, mail.rep_time))

    old_slot = req.slot.clone()
    k = torch.arange(3, device=clock.device)[None, :]
    lat = fill_ps - clock
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


def shl2_requester_fill(ctx: MemCtx, ms: ShL2State, lanes, trace, core,
                        enabled, progress, mem_ok, *,
                        rec: "MemRec | None" = None) -> None:
    """Phase 6 in place on `ms`; adds its events to `progress` and writes
    `mem_ok`."""
    dev = core.clock_ps.device
    if dev.type == "cpu":
        if rec is None:
            rec = MemRec.fetch(lanes, trace, core.idx)
        shl2_requester_fill_plain(ctx, ms, rec, core.clock_ps,
                                  core.freq_mhz.to(torch.int64), enabled,
                                  progress, mem_ok)
        return
    if dev.type != "cuda":
        raise ValueError(f"shl2_requester_fill: unsupported device {dev}")
    KERNEL.launch_bound(*bound_args(ctx, ms, lanes, trace, core, enabled,
                                    progress, mem_ok))
