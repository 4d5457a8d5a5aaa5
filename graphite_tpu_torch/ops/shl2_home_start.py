"""`shl2_home_start`: phase 5 of the shared-L2 engine, the home slices'
transaction starts (MSI and MESI, each directory scheme).

Replaces `_home_starts` (`graphite_tpu/memory/engine_shl2.py:933-1138`)
with `_req_earliest` / `_req_consume` (`graphite_tpu/memory/engine.py:
195-224`).  Kernel: `csrc/shl2_home_start.cu`, one thread a home,
launched through a binding (`build.Kernel.launch_bound`).

Per home slice with no active transaction: resume the request saved
behind a NULLIFY, else pop the earliest pending request addressed to it
(key time * T + requester, the lowest key wins; a popped request is an
L1-D request, its component not being carried); serialize behind the
home's last finished line; look the line up in the slice, else pick the
slice victim: one with L1 copies runs a NULLIFY transaction first (the
request saved), one without is dropped (dirty -> a DRAM write) and the
line installed in DATA_INVALID with an UNCACHED entry.  Then the
directory FSM over the L1 sharers of the effective line: a request on a
line whose DRAM fetch is in flight waits for it (`dram_ready_ps`); a
present line is served, an EX or NULLIFY on SHARED invalidating every
sharer (an upgrading requester's own bit cleared) and anything on
MODIFIED or EXCLUSIVE sending FLUSH (EX, NULLIFY) or WB (SH) to the
owner.  The schemes cap the hardware list at k = `max_hw_sharers`:
`limited_no_broadcast` displaces the lowest sharer (or empties a
MODIFIED / EXCLUSIVE entry, its owner flushed) before a (k+1)-th reader
joins, `ackwise` and `limited_broadcast` send an overflowed entry's
invalidation sweep to every tile but the requester (counted in
`dir_broadcasts`; the acks awaited stay the true holders), and
`limitless` adds the software trap to every start on an overflowed
entry.  The FWD copies go into the home's column through the MEMORY net
(`mem_net_fanout`).

Every write belongs to one home: its slice set and directory rows, its
transaction, its FWD column; the popped requester's request cell belongs
to the one home it addressed.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    FAR, clear_bit, lowest_sharer, req_earliest,
    set_bit, shl2_entry, shl2_fields, shl2_rows, shl2_store, shl2_update,
    test_bit, unpack_sharers,
)
from graphite_tpu_torch.memory.context import (
    CYC_L2_DAT, CYC_SYNC_L2_NET, MemCtx,
)
from graphite_tpu_torch.memory.state import (
    DATA_INVALID, DIR_EXCLUSIVE, DIR_MODIFIED, DIR_SHARED, DIR_UNCACHED,
    MOD_L1D, MSG_EX_REQ, MSG_FLUSH_REQ, MSG_INV_REQ, MSG_NONE, MSG_NULLIFY,
    MSG_SH_REQ, MSG_WB_REQ, ShL2State,
)
from graphite_tpu_torch.ops.build import Kernel, check_width
from graphite_tpu_torch.ops.mem_net_route import net_tensors, pack_with_net
from graphite_tpu_torch.ops.mem_requester import MAX_TILES, engine_values
from graphite_tpu_torch.ops.shl2_requester import shl2_values

_TXN = (("active", torch.bool), ("mtype", torch.uint8),
        ("line", torch.int32), ("requester", torch.int32),
        ("req_comp", torch.uint8), ("time_ps", torch.int64),
        ("dram_ready_ps", torch.int64), ("got_flush", torch.bool),
        ("saved_valid", torch.bool), ("saved_type", torch.uint8),
        ("saved_line", torch.int32), ("saved_requester", torch.int32),
        ("saved_comp", torch.uint8), ("saved_time_ps", torch.int64),
        ("last_line", torch.int32), ("last_done_ps", torch.int64))
_COUNTERS = ("dir_accesses", "dir_broadcasts", "l2_hits", "l2_misses",
             "dram_reads", "dram_writes", "dram_total_lat_ps")


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`Shl2HomeArgs` in
    csrc/shl2_home_start.cu: the pointers, then the plain values)."""
    (ctx,) = key
    mp = ctx.mp
    T, SW = mp.n_tiles, mp.sharer_words
    S2, W2 = mp.l2.num_sets, mp.l2.num_ways
    check_width("shl2_home_start", T, MAX_TILES, "tiles")
    i64, i32, b, u8 = torch.int64, torch.int32, torch.bool, torch.uint8
    t = (T,)
    specs = [("core.freq_mhz", i32, t), ("enabled", b, ()),
             ("progress", i32, (1,)), ("ctx.cyc", i64, (T, 11)),
             ("ctx.sets", i32, (3, T)), ("ctx.ways", i32, (3, T)),
             ("ctx.dram_rt", i64, t), ("l2.meta", i64, (T, S2, W2)),
             ("dir.word", i64, (T, S2, W2)),
             ("dir.sharers", i32, (T, S2, W2 * SW)),
             ("mail.req_type", u8, t), ("mail.req_home", i32, t),
             ("mail.req_line", i32, t), ("mail.req_time", i64, t),
             ("mail.fwd_type", u8, (T, T)), ("mail.fwd_line", i32, (T, T)),
             ("mail.fwd_time", i64, (T, T))]
    specs += [(f"txn.{n}", dt, t) for n, dt in _TXN]
    specs += [("txn.pending", i32, (T, SW))]
    specs += [(f"counters.{n}", i64, t) for n in _COUNTERS]
    return pack_with_net(tensors, specs,
                         (0,) + shl2_values(ctx) + engine_values(ctx),
                         mp.net_hbh, mp.net_atac, T)


KERNEL = Kernel("shl2_home_start", "gt_shl2_home_start", pack=_pack)


def bound_args(ctx: MemCtx, ms: ShL2State, freq, enabled,
               progress) -> tuple:
    """The (tensors, key) a call binds, in `Shl2HomeArgs` order."""
    mail, txn, cnt = ms.mail, ms.txn, ms.counters
    return ((freq, enabled, progress, ctx.cyc, ctx.sets, ctx.ways,
             ctx.dram_rt, ms.l2.meta, ms.dir.word, ms.dir.sharers,
             mail.req_type, mail.req_home, mail.req_line, mail.req_time,
             mail.fwd_type, mail.fwd_line, mail.fwd_time,
             *(getattr(txn, n) for n, _ in _TXN), txn.pending,
             *(getattr(cnt, n) for n in _COUNTERS),
             *net_tensors(ctx.mp, ms.noc)), (ctx,))


def shl2_home_start_plain(ctx: MemCtx, ms: ShL2State, cps, enabled,
                          progress) -> None:
    """Phase 5 in place on `ms`; `cps` is `ctx.cycle_ps` of this
    iteration."""
    mp = ctx.mp
    T = mp.n_tiles
    tiles = ctx.tiles
    i64 = torch.int64
    mail, txn = ms.mail, ms.txn
    l2_access = cps[:, CYC_L2_DAT]

    can_start = ~txn.active
    use_saved = can_start & txn.saved_valid
    r_col, r_found = req_earliest(mail)
    use_pop = can_start & ~use_saved & r_found
    starting = use_saved | use_pop
    rtype = torch.where(use_saved, txn.saved_type, mail.req_type[r_col])
    rline = torch.where(use_saved, txn.saved_line, mail.req_line[r_col])
    rreq = torch.where(use_saved, txn.saved_requester.to(i64), r_col)
    rcomp = torch.where(use_saved, txn.saved_comp, MOD_L1D)
    rtime = (torch.where(use_saved, txn.saved_time_ps, mail.req_time[r_col])
             + torch.where(use_saved, 0, cps[:, CYC_SYNC_L2_NET]))
    rtime = torch.where(starting & (rline == txn.last_line),
                        torch.maximum(rtime, txn.last_done_ps), rtime)
    # the popped requesters' cells (each home pops at most one)
    home = mail.req_home.to(i64)
    popped = ((mail.req_type != MSG_NONE) & use_pop[home]
              & (r_col[home] == tiles))
    mail.req_type.copy_(torch.where(popped, MSG_NONE, mail.req_type))
    txn.saved_valid.copy_(txn.saved_valid & ~use_saved)

    # the slice row and the directory rows at rline's set (the victim
    # and the effective line share it)
    l2r = ca.gather_row(ms.l2.meta, rline, ctx.l2_sets, nonneg=False)
    sets = l2r.sets
    dw, dsh = shl2_rows(ms.dir, sets, tiles)
    l2_hit, _, _ = ca.row_lookup(l2r, rline)
    v_way, v_valid, v_line, v_state = ca.row_pick_victim(
        l2r, mp.l2.replacement, ctx.l2_ways)
    v_dstate = shl2_fields(shl2_entry(dw, dsh, v_way)[0])[0]
    need_alloc = starting & ~l2_hit
    nullify_live = need_alloc & v_valid & (v_dstate != DIR_UNCACHED)
    # a victim with no L1 copies is dropped now (dirty -> DRAM write)
    silent_kill = need_alloc & v_valid & (v_dstate == DIR_UNCACHED)
    l2r = ca.row_invalidate(l2r, v_line, silent_kill)
    dram_wb = silent_kill & (v_state == ca.MODIFIED)
    for name, val in (("valid", True), ("type", rtype), ("line", rline),
                      ("requester", rreq), ("comp", rcomp),
                      ("time_ps", rtime)):
        f = getattr(txn, f"saved_{name}")
        f.copy_(torch.where(nullify_live, val, f))

    # install the new line, DATA_INVALID until DRAM returns
    do_install = need_alloc & ~nullify_live
    l2r = ca.row_insert(l2r, rline, v_way, DATA_INVALID, do_install)
    shl2_update(dw, dsh, v_way, do_install, dstate=DIR_UNCACHED, owner=-1,
                nsharers=0, sharers=torch.zeros_like(txn.pending))

    eff_line = torch.where(nullify_live, v_line, rline.to(i64))
    eff_type = torch.where(nullify_live, MSG_NULLIFY, rtype.to(i64))
    eff_time = rtime + l2_access
    run_req = starting & ~nullify_live
    _, eff_way, eff_l2_state = ca.row_lookup(l2r, eff_line)
    word, sharers = shl2_entry(dw, dsh, eff_way)
    dstate, owner, nsh = shl2_fields(word)

    is_ex = eff_type == MSG_EX_REQ
    is_sh = eff_type == MSG_SH_REQ
    data_missing = run_req & (eff_l2_state == DATA_INVALID)
    served = run_req & ~data_missing
    shared = dstate == DIR_SHARED
    owned_like = (dstate == DIR_MODIFIED) | (dstate == DIR_EXCLUSIVE)

    # fan-outs: EX on SHARED invalidates the sharers, anything on M / E
    # goes to the owner (WB for SH, else FLUSH), NULLIFY sweeps everyone
    fan_inv = (served & is_ex & shared) | (nullify_live & shared)
    fan_owner = (served | nullify_live) & owned_like
    zeros = torch.zeros_like(txn.pending)
    owner_bits = set_bit(zeros, torch.clamp(owner, 0, T - 1), fan_owner)
    pending = torch.where(fan_inv[:, None], sharers, owner_bits)
    fan = fan_inv | fan_owner
    fwd_msg = torch.where(fan_inv, MSG_INV_REQ,
                          torch.where(is_sh, MSG_WB_REQ, MSG_FLUSH_REQ))
    # an upgrading requester does not invalidate its own copy (a NULLIFY
    # sweep does: the victim line's entry dies)
    upgrade_clear = served & is_ex & shared
    rreq_c = torch.clamp(rreq, 0, T - 1)
    pending = clear_bit(pending, rreq_c,
                        upgrade_clear & test_bit(pending, rreq))

    k = mp.max_hw_sharers
    already = test_bit(sharers, rreq)
    over_bc = torch.zeros_like(starting)
    if mp.dir_type == "limited_no_broadcast":
        # SH on SHARED at capacity: displace the lowest tracked sharer
        sh_over = served & is_sh & shared & (nsh >= k) & ~already
        victim = lowest_sharer(sharers)
        victim_bits = set_bit(zeros, torch.clamp(victim, 0, T - 1),
                              sh_over & (victim >= 0))
        shl2_update(dw, dsh, eff_way, sh_over, nsharers=nsh - 1,
                    sharers=sharers & ~victim_bits)
        pending = torch.where(sh_over[:, None], victim_bits, pending)
        fwd_msg = torch.where(sh_over, MSG_INV_REQ, fwd_msg)
        fan = fan | sh_over
        # M / E at capacity: the owner's WB becomes a FLUSH and the entry
        # empties (the finish installs the requester alone)
        sh_over_m = served & is_sh & owned_like & (nsh >= k) & ~already
        fwd_msg = torch.where(sh_over_m, MSG_FLUSH_REQ, fwd_msg)
        shl2_update(dw, dsh, eff_way, sh_over_m, dstate=DIR_UNCACHED,
                    owner=-1, nsharers=0, sharers=zeros)
    if mp.dir_type == "limitless":
        sw_mode = (nsh > k) | (is_sh & ~already & (nsh >= k)
                               & (shared | owned_like))
        eff_time = eff_time + torch.where(enabled & starting & sw_mode,
                                          ctx.timing.trap_ps, 0)
    ca.scatter_row(ms.l2.meta, l2r)
    shl2_store(ms.dir, sets, tiles, dw, dsh)

    txn.active.copy_(txn.active | starting)
    txn.mtype.copy_(torch.where(starting, eff_type, txn.mtype))
    txn.line.copy_(torch.where(starting, eff_line, txn.line))
    txn.requester.copy_(torch.where(starting, rreq, txn.requester))
    txn.req_comp.copy_(torch.where(starting, rcomp, txn.req_comp))
    txn.time_ps.copy_(torch.where(starting, eff_time, txn.time_ps))
    txn.pending.copy_(torch.where(starting[:, None], pending, txn.pending))
    txn.got_flush.copy_(txn.got_flush & ~starting)
    txn.dram_ready_ps.copy_(torch.where(
        data_missing, eff_time + torch.where(enabled, ctx.dram_rt, 0),
        torch.where(starting, FAR, txn.dram_ready_ps)))

    # the FWD copies into the home's column
    send = fan[:, None] & unpack_sharers(pending, T)
    if mp.dir_type in ("ackwise", "limited_broadcast"):
        over_bc = fan_inv & (nsh > k)
        send = send | (over_bc[:, None] & (tiles[None, :] != rreq_c[:, None]))
    arrive = net.fanout(ctx, ms, send, eff_time, enabled)
    send_t = send.T
    mail.fwd_type.copy_(torch.where(send_t, fwd_msg.to(torch.uint8)[None, :],
                                    mail.fwd_type))
    mail.fwd_line.copy_(torch.where(send_t, eff_line.to(torch.int32)[None, :],
                                    mail.fwd_line))
    mail.fwd_time.copy_(torch.where(send_t, arrive.T, mail.fwd_time))

    cnt = ms.counters
    dram = data_missing & enabled
    cnt.dir_accesses.add_((starting & enabled).to(i64))
    cnt.dir_broadcasts.add_((over_bc & enabled).to(i64))
    cnt.l2_hits.add_((served & enabled).to(i64))
    cnt.l2_misses.add_(dram.to(i64))
    cnt.dram_reads.add_(dram.to(i64))
    cnt.dram_writes.add_((dram_wb & enabled).to(i64))
    cnt.dram_total_lat_ps.add_(torch.where(dram, ctx.timing.dram_lat_ps, 0))
    progress.add_(torch.sum(starting, dtype=torch.int32))


def shl2_home_start(ctx: MemCtx, ms: ShL2State, freq, enabled,
                    progress) -> None:
    """Phase 5 in place on `ms`; adds its events to `progress`."""
    dev = enabled.device
    if dev.type == "cpu":
        shl2_home_start_plain(ctx, ms, ctx.cycle_ps(freq, enabled), enabled,
                              progress)
        return
    if dev.type != "cuda":
        raise ValueError(f"shl2_home_start: unsupported device {dev}")
    KERNEL.launch_bound(*bound_args(ctx, ms, freq, enabled, progress))
