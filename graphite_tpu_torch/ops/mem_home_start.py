"""`mem_home_start`: phase 3 of the memory engine, the homes' transaction
starts (MSI and MOSI, each directory scheme).

Replaces `_home_starts` (`graphite_tpu/memory/engine.py:2219-2546`)
with `_req_earliest` (`:195-215`) and `_req_consume` (`:217-224`).
Kernel: `csrc/mem_home_start.cu`, one thread a home, launched through a
binding (`build.Kernel.launch_bound`); MOSI and the limited schemes
launch its second entry point, `mem_home_start[ext]`.

Per home with no active transaction: resume the request saved behind a
NULLIFY, else pop the earliest pending request addressed to it (key
time * T + requester, the lowest key wins); look the line up in the
home's directory set, else take a free way, else the way with the
fewest sharers, whose live entry is first NULLIFY'd (the request is
saved); then the state branch: UNCACHED requests (and, under MSI, SH on
SHARED) finish at once (the entry is written, DRAM or the home's
flushed-data buffer serves the reply), EX and NULLIFY on SHARED (MOSI:
and OWNED) invalidate every sharer, anything on MODIFIED sends FLUSH
(EX, NULLIFY) or WB (SH) to the owner, and under MOSI an SH on SHARED or
OWNED fetches the line from the owner or the lowest sharer (WB), an
invalidation sweep's supplier getting FLUSH — into the FWD column the
home owns.  The directory scheme caps the hardware list at k =
`max_hw_sharers`: `limited_no_broadcast` displaces a sharer (or flushes
a MODIFIED owner) before a (k+1)-th reader joins, `ackwise` and
`limited_broadcast` send an overflowed entry's sweep to every tile
(counted in `dir_broadcasts`; the acks awaited stay the true holders),
and `limitless` adds the software trap to every access of an overflowed
entry.

Every write is owned by one thread: the home's directory set, its
transaction, its FWD column; the popped requester's request cell and
the replied requester's reply cell belong to exactly one home this
phase (a requester has one outstanding miss).
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.intmath import nn_mod
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    dir_nsh, dir_owner, dir_state, dir_tag, dir_word, gated, lowest_sharer,
    popcount, req_earliest, set_bit, test_bit, unpack_sharers,
)
from graphite_tpu_torch.memory.context import MemCtx
from graphite_tpu_torch.ops.build import Kernel
from graphite_tpu_torch.ops.mem_net_route import net_tensors, pack_with_net
from graphite_tpu_torch.memory.state import (
    DIR_MODIFIED, DIR_OWNED, DIR_SHARED, DIR_UNCACHED, MSG_EX_REP, MSG_EX_REQ,
    MSG_FLUSH_REQ, MSG_INV_REQ, MSG_NONE, MSG_NULLIFY, MSG_SH_REP,
    MSG_SH_REQ, MSG_WB_REQ, MemState,
)


_TXN = (("active", torch.bool), ("mtype", torch.uint8),
        ("line", torch.int32), ("requester", torch.int32),
        ("time_ps", torch.int64), ("data_cached", torch.bool),
        ("saved_valid", torch.bool), ("saved_type", torch.uint8),
        ("saved_line", torch.int32), ("saved_requester", torch.int32),
        ("saved_time_ps", torch.int64), ("last_line", torch.int32),
        ("last_done_ps", torch.int64), ("cdata_line", torch.int32),
        ("cdata_valid", torch.bool))


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`HomeArgs` in
    csrc/mem_home_start.cu: the pointers, then `MemConsts`)."""
    from graphite_tpu_torch.ops.mem_requester import engine_values

    (ctx,) = key
    mp = ctx.mp
    T, DS, DW, SW = mp.n_tiles, mp.dir_sets, mp.dir_ways, mp.sharer_words
    i64, i32, b, u8 = torch.int64, torch.int32, torch.bool, torch.uint8
    t = (T,)
    specs = [("enabled", b, ()), ("progress", i32, (1,)),
             ("dir.entry", i64, (T, DS, DW)),
             ("dir.sharers", i32, (T, DS, DW * SW)),
             ("mail.req_type", u8, t), ("mail.req_home", i32, t),
             ("mail.req_line", i32, t), ("mail.req_time", i64, t),
             ("mail.rep_type", u8, t), ("mail.rep_time", i64, t),
             ("mail.fwd_type", u8, (T, T)), ("mail.fwd_line", i32, (T, T)),
             ("mail.fwd_time", i64, (T, T))]
    specs += [(f"txn.{n}", dt, t) for n, dt in _TXN]
    specs += [("txn.pending", i32, (T, SW)),
              ("counters.dir_accesses", i64, t),
              ("counters.dram_reads", i64, t),
              ("counters.dram_total_lat_ps", i64, t),
              ("counters.dir_broadcasts", i64, t)]
    return pack_with_net(tensors, specs, (0,) + engine_values(ctx),
                         mp.net_hbh, mp.net_atac, T)


KERNEL = Kernel("mem_home_start", "gt_mem_home_start", pack=_pack)
# the instantiation with the MOSI and scheme branches, counted apart
KERNEL_EXT = Kernel("mem_home_start[ext]", "gt_mem_home_start_ext",
                    pack=_pack, lib="mem_home_start")


def kernel_for(ctx: MemCtx) -> Kernel:
    """The entry point a call under `ctx` launches: MSI full_map keeps
    the one without the MOSI and scheme branches."""
    mp = ctx.mp
    return KERNEL_EXT if mp.is_mosi or mp.dir_type != "full_map" else KERNEL


def bound_args(ctx: MemCtx, ms: MemState, enabled, progress) -> tuple:
    """The (tensors, key) a call binds, in `HomeArgs` order."""
    mail, txn, cnt = ms.mail, ms.txn, ms.counters
    return ((enabled, progress, ms.directory.entry, ms.directory.sharers,
             mail.req_type, mail.req_home, mail.req_line, mail.req_time,
             mail.rep_type, mail.rep_time, mail.fwd_type, mail.fwd_line,
             mail.fwd_time, *(getattr(txn, n) for n, _ in _TXN),
             txn.pending, cnt.dir_accesses, cnt.dram_reads,
             cnt.dram_total_lat_ps, cnt.dir_broadcasts,
             *net_tensors(ctx.mp, ms.noc)), (ctx,))


def dir_view(ms: MemState, line, rows):
    """Each home's directory set at `line` (`rows` = 0..T-1): (sets,
    words [T, DW], sharer rows [T, DW, SW], found, way)."""
    d = ms.directory
    T, DS, DW = d.entry.shape
    sets = nn_mod(line.to(torch.int64), DS)
    words = d.entry[rows, sets]
    sh = d.sharers.view(T, DS, DW, -1)[rows, sets]
    hits = dir_tag(words) == line[:, None]
    return sets, words, sh, hits.any(dim=1), first_index(hits)


def first_index(m: torch.Tensor) -> torch.Tensor:
    return torch.argmax(m.to(torch.int8), dim=1)


def dir_write(ms: MemState, rows, sets, way, mask, *, tags=None,
              dstate=None, owner=None, sharers=None, nsharers=None) -> None:
    """Masked in-place write of one entry per home (`_dir_update`)."""
    d = ms.directory
    T, DS, DW = d.entry.shape
    cur = d.entry[rows, sets, way]
    new = dir_word(tags, dstate, owner, nsharers, cur)
    d.entry[rows, sets, way] = torch.where(mask, new, cur)
    if sharers is not None:
        sh4 = d.sharers.view(T, DS, DW, -1)
        cur_sh = sh4[rows, sets, way]
        sh4[rows, sets, way] = torch.where(mask[:, None], sharers, cur_sh)


def send_reply(mail, to, go, msg, arrival) -> None:
    """Reply cells of the requesters `to` where `go`.  The JAX engine
    adds into cells that are zero (each requester has one outstanding
    miss); masked-off homes add 0 to cell 0."""
    wr = torch.where(go, to.to(torch.int64), 0)
    rt = mail.rep_type.to(torch.int64)
    rt.index_put_((wr,), torch.where(go, msg, 0).to(torch.int64),
                  accumulate=True)
    mail.rep_type.copy_(rt.to(torch.uint8))
    mail.rep_time.index_put_((wr,), torch.where(go, arrival, 0),
                             accumulate=True)


def mem_home_start_plain(ctx: MemCtx, ms: MemState, enabled,
                         progress) -> None:
    mp, tm = ctx.mp, ctx.timing
    T = mp.n_tiles
    SW = mp.sharer_words
    dev = enabled.device
    tiles = ctx.tiles
    i64 = torch.int64
    mail, txn = ms.mail, ms.txn
    dram_lat = gated(tm.dram_lat_ps, enabled)
    dir_access = gated(tm.dir_access_ps, enabled)
    sync_dir_l2 = gated(tm.sync_dir_l2_ps, enabled)
    sync_dir_net = gated(tm.sync_dir_net_ps, enabled)

    can_start = ~txn.active
    use_saved = can_start & txn.saved_valid
    r_col, r_found = req_earliest(mail)
    use_pop = can_start & ~use_saved & r_found
    starting = use_saved | use_pop
    rtype = torch.where(use_saved, txn.saved_type.to(i64),
                        mail.req_type[r_col].to(i64))
    rline = torch.where(use_saved, txn.saved_line, mail.req_line[r_col])
    rreq = torch.where(use_saved, txn.saved_requester.to(i64), r_col)
    rtime = torch.where(use_saved, txn.saved_time_ps, mail.req_time[r_col])
    # the directory's message sync, once per message (a resumed request
    # paid it when it first arrived)
    rtime = rtime + torch.where(
        use_saved, 0, torch.where(rreq == tiles, sync_dir_l2, sync_dir_net))
    # same-address serialization floor
    rtime = torch.where(starting & (rline == txn.last_line),
                        torch.maximum(rtime, txn.last_done_ps), rtime)
    # consume the popped requester lanes (each home pops at most one)
    home = mail.req_home.to(i64)
    popped = ((mail.req_type != MSG_NONE) & use_pop[home]
              & (r_col[home] == tiles))
    mail.req_type.copy_(torch.where(popped, MSG_NONE, mail.req_type))
    txn.saved_valid.copy_(txn.saved_valid & ~use_saved)

    # directory lookup / allocation
    sets, words, sh, dfound, way = dir_view(ms, rline, tiles)
    tag_row, nsh_row = dir_tag(words), dir_nsh(words)
    free_ways = tag_row == -1
    any_free = free_ways.any(dim=1)
    victim_way = torch.argmin(nsh_row, dim=1)
    alloc_way = torch.where(dfound, way, torch.where(
        any_free, first_index(free_ways), victim_way))
    need_nullify = starting & ~dfound & ~any_free
    v_word = torch.gather(words, 1, alloc_way[:, None])[:, 0]
    v_line, v_dstate = dir_tag(v_word), dir_state(v_word)
    v_owner, v_nsh = dir_owner(v_word), dir_nsh(v_word)
    v_sharers = sh[tiles, alloc_way]
    is_new = starting & ~dfound

    # NULLIFY: save the request, run the nullify on the victim line
    nullify_live = need_nullify & (v_dstate != DIR_UNCACHED)
    for f, v in (("saved_valid", True), ("saved_type", rtype),
                 ("saved_line", rline), ("saved_requester", rreq),
                 ("saved_time_ps", rtime)):
        cur = getattr(txn, f)
        cur.copy_(torch.where(nullify_live, v, cur).to(cur.dtype))

    run_req = starting & ~nullify_live
    dstate = torch.where(dfound, v_dstate, DIR_UNCACHED)
    eff_line = torch.where(nullify_live, v_line, rline)
    eff_type = torch.where(nullify_live, MSG_NULLIFY, rtype)
    eff_dstate = torch.where(nullify_live, v_dstate, dstate)
    eff_time = rtime + dir_access
    is_ex = eff_type == MSG_EX_REQ
    is_sh = eff_type == MSG_SH_REQ
    uncached = eff_dstate == DIR_UNCACHED
    shared = eff_dstate == DIR_SHARED
    modified = eff_dstate == DIR_MODIFIED
    owned = eff_dstate == DIR_OWNED
    zeros_sw = torch.zeros((T, SW), dtype=torch.int32, device=dev)
    no = torch.zeros(T, dtype=torch.bool, device=dev)

    # the directory scheme: the hardware list holds k sharers
    k = mp.max_hw_sharers
    already = test_bit(v_sharers, rreq)
    sh_over = sh_over_m = no
    if mp.dir_type == "limited_no_broadcast":
        # a (k+1)-th reader displaces a tracked sharer; a MODIFIED entry
        # at capacity flushes its owner out instead
        at_cap = run_req & is_sh & (v_nsh >= k) & ~already
        sh_over = at_cap & (shared | owned)
        sh_over_m = at_cap & modified
    if mp.dir_type == "limitless":
        # an overflowed entry is served by the software trap
        sw_mode = (v_nsh > k) | (is_sh & ~already & (v_nsh >= k)
                                 & (shared | owned))
        eff_time = eff_time + torch.where(
            enabled & starting & dfound & sw_mode, tm.trap_ps, 0)

    # (a) immediate finishes: UNCACHED requests; MSI also serves SH on
    # SHARED from DRAM (MOSI fetches it cache-to-cache, below)
    imm_ex = run_req & is_ex & uncached
    if mp.is_mosi:
        imm_sh = run_req & is_sh & uncached
    else:
        imm_sh = run_req & is_sh & (uncached | shared) & ~sh_over
    imm = imm_ex | imm_sh
    rbit = set_bit(zeros_sw, rreq, imm)
    cur_sh = torch.where((imm_sh & shared)[:, None], v_sharers, 0)
    had = test_bit(cur_sh, rreq)
    # one write: the new entry's install (UNCACHED, empty) and the
    # immediate finish; the finish wins where both apply
    dir_write(
        ms, tiles, sets, alloc_way, is_new | imm,
        tags=torch.where(is_new, rline, v_line),
        dstate=torch.where(imm, torch.where(imm_ex, DIR_MODIFIED,
                                            DIR_SHARED), DIR_UNCACHED),
        owner=torch.where(imm_ex, rreq, -1),
        sharers=torch.where(imm[:, None], cur_sh | rbit, 0),
        nsharers=torch.where(imm_ex, 1, torch.where(
            imm, popcount(cur_sh) + (~had).to(torch.int32), 0)))
    cdata_imm = txn.cdata_valid & (txn.cdata_line == eff_line) & imm
    rep_ready = eff_time + torch.where(cdata_imm, 0, dram_lat)
    txn.cdata_valid.copy_(txn.cdata_valid & ~cdata_imm)
    arrival = net.send(ctx, ms, tiles, rreq, True, rep_ready, imm, enabled,
                       plain=True)
    send_reply(mail, rreq, imm, torch.where(imm_ex, MSG_EX_REP, MSG_SH_REP),
               arrival)
    txn.last_line.copy_(torch.where(imm, eff_line, txn.last_line))
    txn.last_done_ps.copy_(torch.where(imm, rep_ready, txn.last_done_ps))

    # (b) fan-out: EX/NULLIFY on SHARED (MOSI: and OWNED) -> INV every
    # sharer; anything on MODIFIED -> FLUSH (WB for SH) to the owner;
    # MOSI's SH on SHARED/OWNED -> WB to one holder (cache-to-cache)
    if mp.is_mosi:
        fan_inv = ((run_req & is_ex) | nullify_live) & (shared | owned)
        sh_fetch = run_req & is_sh & (shared | owned) & ~sh_over
    else:
        fan_inv = (run_req & is_ex & shared) | (nullify_live & shared)
        sh_fetch = no
    fan_owner = (run_req | nullify_live) & modified
    fan = fan_inv | fan_owner | sh_fetch | sh_over
    owner_c = torch.clamp(v_owner, 0, T - 1)
    owner_bits = set_bit(zeros_sw, owner_c, fan_owner)
    # the cache-to-cache source: the owner of an OWNED entry, else the
    # lowest sharer
    dirty_owner = owned & (v_owner >= 0)
    fetch_src = torch.where(dirty_owner, v_owner, lowest_sharer(v_sharers))
    fetch_bits = set_bit(zeros_sw, torch.clamp(fetch_src, 0, T - 1),
                         sh_fetch & (fetch_src >= 0))
    pending = torch.where(fan_inv[:, None], v_sharers, torch.where(
        sh_fetch[:, None], fetch_bits, owner_bits))
    fwd_msg = torch.where(fan_inv, MSG_INV_REQ,
                          torch.where(is_sh, MSG_WB_REQ, MSG_FLUSH_REQ))
    # the one target whose copy differs (-1: none) and its message
    ovr_col = torch.full((T,), -1, dtype=i64, device=dev)
    ovr_msg = torch.full((T,), MSG_FLUSH_REQ, dtype=i64, device=dev)
    if mp.is_mosi:
        # the sweep's data supplier gets INV_FLUSH_COMBINED: the owner of
        # an OWNED entry, else the lowest sharer for an EX on SHARED
        pick = fan_inv & (owned | (run_req & is_ex & shared))
        ovr_col = torch.where(pick, fetch_src, ovr_col)
    if mp.dir_type == "limited_no_broadcast":
        # the victim: the lowest sharer that is not the dirty owner, else
        # the owner itself; it leaves the entry now, its ack is this
        # transaction's
        owner_word = set_bit(zeros_sw, owner_c, dirty_owner)
        victim0 = lowest_sharer(v_sharers & ~owner_word)
        victim_is_owner = sh_over & (victim0 < 0)
        victim = torch.where(victim0 >= 0, victim0, owner_c)
        victim_bits = set_bit(zeros_sw, victim, sh_over)
        dir_write(ms, tiles, sets, alloc_way, sh_over,
                  sharers=v_sharers & ~victim_bits, nsharers=v_nsh - 1,
                  owner=torch.where(victim_is_owner, -1, v_owner),
                  dstate=torch.where(victim_is_owner, DIR_SHARED,
                                     eff_dstate))
        # acks awaited: the victim, and an OWNED entry's owner, which
        # supplies the data alongside
        ow_pend = set_bit(zeros_sw, owner_c,
                          sh_over & owned & ~victim_is_owner
                          & (v_owner >= 0))
        pending = torch.where(sh_over[:, None], victim_bits | ow_pend,
                              pending)
        fwd_msg = torch.where(sh_over, MSG_INV_REQ, fwd_msg)
        fwd_msg = torch.where(sh_over_m, MSG_FLUSH_REQ, fwd_msg)
        # M -> S at capacity: the entry empties, the finish installs the
        # requester alone
        dir_write(ms, tiles, sets, alloc_way, sh_over_m,
                  sharers=zeros_sw, nsharers=torch.zeros_like(v_nsh),
                  owner=torch.full_like(v_owner, -1),
                  dstate=torch.full_like(v_dstate, DIR_UNCACHED))
        if mp.is_mosi:
            # the data supplier of the displacing SH: the victim FLUSHes
            # where it must both leave and supply, else the owner WBs
            vflush = sh_over & (shared | victim_is_owner)
            owb = sh_over & owned & ~victim_is_owner
            ovr_col = torch.where(vflush, victim,
                                  torch.where(owb, owner_c, ovr_col))
            ovr_msg = torch.where(owb, MSG_WB_REQ, ovr_msg)
    txn.active.copy_(txn.active | fan)
    txn.mtype.copy_(torch.where(fan, eff_type, txn.mtype.to(i64)).to(
        torch.uint8))
    txn.line.copy_(torch.where(fan, eff_line, txn.line))
    txn.requester.copy_(torch.where(fan, rreq, txn.requester.to(i64)).to(
        torch.int32))
    txn.time_ps.copy_(torch.where(fan, eff_time, txn.time_ps))
    txn.pending.copy_(torch.where(fan[:, None], pending, txn.pending))
    txn.data_cached.copy_(txn.data_cached & ~fan)

    # the multicast into the FWD matrix [sharer, home], against the
    # queues the replies committed; an overflowed ackwise /
    # limited_broadcast entry's sweep goes to every tile (the acks
    # awaited stay the true holders: a non-holder drops its copy)
    send_hs = fan[:, None] & unpack_sharers(pending, T)
    over_bc = no
    if mp.dir_type in ("ackwise", "limited_broadcast"):
        over_bc = fan_inv & (v_nsh > k)
        send_hs = send_hs | over_bc[:, None]
    send_t = send_hs.T
    msg_hs = torch.where(tiles[None, :] == ovr_col[:, None],
                         ovr_msg[:, None], fwd_msg[:, None])
    arrive = net.fanout(ctx, ms, send_hs, eff_time, enabled).T
    mail.fwd_type.copy_(torch.where(send_t, msg_hs.T.to(torch.uint8),
                                    mail.fwd_type))
    mail.fwd_line.copy_(torch.where(send_t, eff_line[None, :],
                                    mail.fwd_line))
    mail.fwd_time.copy_(torch.where(send_t, arrive, mail.fwd_time))

    cnt = ms.counters
    dram = imm & ~cdata_imm & enabled
    cnt.dir_accesses.add_((starting & enabled).to(i64))
    cnt.dram_reads.add_(dram.to(i64))
    cnt.dram_total_lat_ps.add_(torch.where(dram, dram_lat, 0))
    cnt.dir_broadcasts.add_((over_bc & enabled).to(i64))
    progress.add_(torch.sum(starting, dtype=torch.int32))


def mem_home_start(ctx: MemCtx, ms: MemState, enabled, progress) -> None:
    """Phase 3 in place on `ms`; adds its events to `progress`."""
    dev = enabled.device
    if dev.type == "cpu":
        mem_home_start_plain(ctx, ms, enabled, progress)
        return
    if dev.type != "cuda":
        raise ValueError(f"mem_home_start: unsupported device {dev}")
    kernel_for(ctx).launch_bound(*bound_args(ctx, ms, enabled, progress))
