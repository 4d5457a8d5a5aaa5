"""`mem_requester`: phase 1 of the memory engine, the requesters' slot
starts (the app thread's L1/L2 path), all `requester_unroll` repeats.

Replaces `_requester_once` (`graphite_tpu/memory/engine.py:1378-1660`)
with `_apply_functional` (`:1847-1864`) and the unroll loop
(`:1684-1688`).  Kernel: `csrc/mem_requester.cu`, one CTA, one lane a
thread, launched through a binding (`build.Kernel.launch_bound`).

Per lane whose record has a slot left to start (active, requester idle):
the instruction-buffer fast path, the L1 lookup (L1-I for the icache
slot, else L1-D), on an L1 miss the L2 lookup and fill of the L1 from
the L2, on an L2 miss the request to the line's home (an upgrade of a
readable L2 line first invalidates it and sends its eviction, unless the
home's eviction cell is busy), the slot bookkeeping, the miss counters
and miss types, the L2 line utilization, and the functional store.

The functional store is the only state two lanes can write in one
phase: lanes storing to the same word in one repeat.  The JAX scatter
(`func_mem.at[word].set(value)`) is run by XLA on the CPU as a loop over
the lanes in order, so the highest lane's value stays; both versions
here give the word to the highest writing lane, and a checking load
reads the word after every store of its repeat.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    U32, arange, ccycles, mt_test, mt_update, next_present_slot,
    slots_present, util_classify, util_inc,
)
from graphite_tpu_torch.memory.context import (
    CYC_L1D_DAT, CYC_L1D_TAG, CYC_L1I_DAT, CYC_L1I_TAG, CYC_L2_DAT,
    CYC_L2_TAG, CYC_SYNC_CORE_L1D, CYC_SYNC_CORE_L1I, CYC_SYNC_L1D_L2,
    CYC_SYNC_L1I_L2, MemCtx, MemRec,
)
from graphite_tpu_torch.memory.params import SCHEMES
from graphite_tpu_torch.memory.state import (
    MOD_L1D, MOD_L1I, MSG_EX_REQ, MSG_FLUSH_REP, MSG_INV_REP, MSG_NONE,
    MSG_SH_REQ, MT_EVICTED, MT_FETCHED, MT_INVALIDATED, MT_WORDS, PHASE_IDLE,
    PHASE_WAIT_REPLY, MemState,
)
from graphite_tpu_torch.ops.build import Kernel, check_width
from graphite_tpu_torch.ops.mem_net_route import (
    net_kind, net_tensors, pack_with_net,
)
from graphite_tpu_torch.trace.schema import (
    FLAG_CHECK, FLAG_MEM0_WRITE, FLAG_MEM1_WRITE,
)


# the kernel holds a lane a thread in one CTA
MAX_TILES = 1024
_COUNTERS = ("l1i_hits", "l1i_misses", "l1d_read_hits", "l1d_read_misses",
             "l1d_write_hits", "l1d_write_misses", "l2_hits", "l2_misses",
             "l2_cold_misses", "l2_capacity_misses", "l2_sharing_misses",
             "line_util_reads", "line_util_writes", "line_util_hist")
_REQ = (("phase", torch.int32), ("slot", torch.int32),
        ("acc_ps", torch.int64), ("clock_ps", torch.int64),
        ("line", torch.int32), ("is_write", torch.bool),
        ("component", torch.uint8), ("instr_buf", torch.int32))


def engine_values(ctx: MemCtx) -> tuple:
    """The plain values every memory kernel's argument block ends with
    (`MemConsts` in csrc/mem_common.cuh)."""
    mp, tm = ctx.mp, ctx.timing
    return (mp.n_tiles, mp.line_bits, mp.func_mem_words,
            max(int(mp.requester_unroll), 1), int(mp.icache_modeling),
            int(mp.l1i.replacement == "round_robin"),
            int(mp.l1d.replacement == "round_robin"),
            int(mp.l2.replacement == "round_robin"),
            int(mp.l2.track_miss_types), int(mp.l2.track_line_utilization),
            net_kind(mp), mp.net_freq_mhz, mp.mesh_width,
            mp.hop_latency_cycles, mp.flit_width_bits, mp.req_bits,
            mp.rep_bits, len(mp.mc_tiles), mp.l1i.num_sets, mp.l1i.num_ways,
            mp.l1d.num_sets, mp.l1d.num_ways, mp.l2.num_sets,
            mp.l2.num_ways, mp.dir_sets, mp.dir_ways, mp.sharer_words,
            tm.dram_lat_ps, tm.dir_access_ps, tm.sync_dir_l2_ps,
            tm.sync_dir_net_ps, int(mp.is_mosi), SCHEMES.index(mp.dir_type),
            mp.max_hw_sharers, tm.trap_ps)


def cache_specs(ctx: MemCtx) -> list:
    """(name, dtype, shape) of the context tables and the cache arrays."""
    mp = ctx.mp
    T = mp.n_tiles
    i64, i32 = torch.int64, torch.int32
    l2s = (T, mp.l2.num_sets, mp.l2.num_ways)
    return [("ctx.cyc", i64, (T, 11)), ("ctx.sets", i32, (3, T)),
            ("ctx.ways", i32, (3, T)), ("ctx.mc", i32, (len(mp.mc_tiles),)),
            ("l1i.meta", i64, (T, mp.l1i.num_sets, mp.l1i.num_ways)),
            ("l1d.meta", i64, (T, mp.l1d.num_sets, mp.l1d.num_ways)),
            ("l2.meta", i64, l2s), ("l2_cloc", torch.uint8, l2s),
            ("l2_util", i64, l2s), ("mt", i64, (T, 3, MT_WORDS))]


def cache_tensors(ctx: MemCtx, ms: MemState) -> tuple:
    return (ctx.cyc, ctx.sets, ctx.ways, ctx.mc, ms.l1i.meta, ms.l1d.meta,
            ms.l2.meta, ms.l2_cloc, ms.l2_util, ms.mt)


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`ReqArgs` in
    csrc/mem_requester.cu: the pointers, then `MemConsts`)."""
    ctx, L = key[0], key[1]
    mp = ctx.mp
    T = mp.n_tiles
    check_width("mem_requester", T, MAX_TILES, "tiles")
    i64, i32, b, u8 = torch.int64, torch.int32, torch.bool, torch.uint8
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.flags", i32, t),
             ("lanes.pc", i64, t), ("lanes.aux0", i32, t),
             ("lanes.aux1", i32, t), ("lanes.active", b, t),
             ("trace.addr0", i64, (T, L)), ("trace.addr1", i64, (T, L)),
             ("core.idx", i32, t), ("core.clock_ps", i64, t),
             ("core.freq_mhz", i32, t), ("enabled", b, ()),
             ("progress", i32, (1,))]
    specs += cache_specs(ctx)
    specs += [("mail.req_type", u8, t), ("mail.req_home", i32, t),
              ("mail.req_line", i32, t), ("mail.req_time", i64, t),
              ("mail.evict_type", u8, (T, T)),
              ("mail.evict_line", i32, (T, T)),
              ("mail.evict_time", i64, (T, T))]
    specs += [(f"req.{n}", dt, t) for n, dt in _REQ]
    specs += [("req.slot_lat_ps", i64, (T, 3))]
    specs += [(f"counters.{n}", i64, (T, 8) if n == "line_util_hist" else t)
              for n in _COUNTERS]
    specs += [("func_mem", i64, (max(mp.func_mem_words, 1) + 1,)),
              ("func_errors", i64, ())]
    return pack_with_net(tensors, specs, (L,) + engine_values(ctx),
                         mp.net_hbh, mp.net_atac, T)


KERNEL = Kernel("mem_requester", "gt_mem_requester", pack=_pack)


def bound_args(ctx: MemCtx, ms: MemState, lanes, trace, core, enabled,
               progress) -> tuple:
    """The (tensors, key) a call binds, in `ReqArgs` order."""
    mail, req, cnt = ms.mail, ms.req, ms.counters
    return ((lanes.op, lanes.flags, lanes.pc, lanes.aux0, lanes.aux1,
             lanes.active, trace.addr0, trace.addr1, core.idx, core.clock_ps,
             core.freq_mhz, enabled, progress, *cache_tensors(ctx, ms),
             mail.req_type, mail.req_home, mail.req_line, mail.req_time,
             mail.evict_type, mail.evict_line, mail.evict_time,
             *(getattr(req, n) for n, _ in _REQ), req.slot_lat_ps,
             *(getattr(cnt, n) for n in _COUNTERS), ms.func_mem,
             ms.func_errors, *net_tensors(ctx.mp, ms.noc)),
            (ctx, trace.addr0.shape[1]))


def apply_functional(ctx: MemCtx, ms: MemState, rec: MemRec, slot, s_addr,
                     s_write, mask) -> None:
    """Stores of the completed slots write the functional store (the
    highest writing lane wins a word), then FLAG_CHECK loads compare the
    word with aux0 (`engine.py:1847-1864`)."""
    nw = ctx.mp.func_mem_words
    if nw <= 0:
        return
    T = slot.shape[0]
    lanes = arange(T, slot.device)
    word = torch.fmod(s_addr >> 2, nw)
    value = torch.where(slot == 1, rec.aux0, rec.aux1).to(torch.int64) & U32
    wr = mask & s_write
    # a writer wins its word unless a higher lane writes it too
    later = ((word[:, None] == word[None, :]) & wr[None, :]
             & (lanes[None, :] > lanes[:, None]))
    win = wr & ~later.any(dim=1)
    fm = ms.func_mem
    fm[torch.where(win, word, nw)] = torch.where(win, value, 0)
    check = mask & ~s_write & (slot == 1) & ((rec.flags & FLAG_CHECK) != 0)
    loaded = fm[word]
    ms.func_errors.add_(torch.sum(check & (loaded != (rec.aux0.to(
        torch.int64) & U32))))


def requester_once(ctx: MemCtx, ms: MemState, rec: MemRec, clock, fmhz,
                   active, enabled) -> torch.Tensor:
    """One repeat of phase 1 in place on `ms`; returns its progress."""
    mp = ctx.mp
    dev = clock.device
    tiles = ctx.tiles
    i64 = torch.int64
    req, mail, cnt = ms.req, ms.mail, ms.counters
    cps = ctx.cycle_ps(fmhz, enabled)

    def cc(col):
        return cps[:, col]

    present = slots_present(mp, rec.op, rec.flags, enabled)
    slot = next_present_slot(present, req.slot)
    starting = active & (req.phase == PHASE_IDLE) & (slot < 3)
    icache = slot == 0
    s_addr = torch.where(icache, rec.pc & U32,
                         torch.where(slot == 1, rec.addr0, rec.addr1))
    s_line = (s_addr >> mp.line_bits).to(torch.int32)
    s_write = torch.where(
        icache, False,
        torch.where(slot == 1, (rec.flags & FLAG_MEM0_WRITE) != 0,
                    (rec.flags & FLAG_MEM1_WRITE) != 0))

    ibuf_hit = starting & icache & (s_line == req.instr_buf)
    new_instr_buf = torch.where(starting & icache, s_line, req.instr_buf)

    l1i_row = ca.gather_row(ms.l1i.meta, s_line, ctx.l1i_sets)
    l1d_row = ca.gather_row(ms.l1d.meta, s_line, ctx.l1d_sets)
    l2_row = ca.gather_row(ms.l2.meta, s_line, ctx.l2_sets)
    if mp.l2.track_miss_types:
        in_e = mt_test(ms.mt, MT_EVICTED, s_line)
        in_i = mt_test(ms.mt, MT_INVALIDATED, s_line)
        in_f = mt_test(ms.mt, MT_FETCHED, s_line)
    if mp.l2.track_line_utilization:
        lu_row = ms.l2_util[tiles, l2_row.sets]
    _, l1i_way, l1i_state = ca.row_lookup(l1i_row, s_line)
    _, l1d_way, l1d_state = ca.row_lookup(l1d_row, s_line)
    l1_state = torch.where(icache, l1i_state, l1d_state)
    l1_permit = torch.where(s_write, ca.state_writable(l1_state),
                            ca.state_readable(l1_state))
    do_l1 = starting & ~ibuf_hit

    sync_core = torch.where(icache, cc(CYC_SYNC_CORE_L1I),
                            cc(CYC_SYNC_CORE_L1D))
    l1_dat = torch.where(icache, cc(CYC_L1I_DAT), cc(CYC_L1D_DAT))
    l1_tag = torch.where(icache, cc(CYC_L1I_TAG), cc(CYC_L1D_TAG))
    sync_l1_l2 = torch.where(icache, cc(CYC_SYNC_L1I_L2),
                             cc(CYC_SYNC_L1D_L2))

    l1_hit_now = do_l1 & l1_permit
    l1_miss = do_l1 & ~l1_permit

    _, l2_way, l2_state = ca.row_lookup(l2_row, s_line)
    l2_permit = torch.where(s_write, ca.state_writable(l2_state),
                            ca.state_readable(l2_state))
    l2_hit_now = l1_miss & l2_permit
    l2_miss = l1_miss & ~l2_permit
    upgrade = l2_miss & s_write & ((l2_state == ca.SHARED)
                                   | (l2_state == ca.OWNED))
    upgrade_dirty = upgrade & (l2_state == ca.OWNED)
    s_home = ctx.home_of(s_line)
    stall_start = upgrade & (mail.evict_type[s_home, tiles] != MSG_NONE)
    l2_miss_go = l2_miss & ~stall_start

    sclock = clock + sync_core
    l1_hit_done_ps = sclock + l1_dat
    if mp.l1i.replacement != "round_robin":
        l1i_row = ca.row_touch(l1i_row, l1i_way, l1_hit_now & icache)
    if mp.l1d.replacement != "round_robin":
        l1d_row = ca.row_touch(l1d_row, l1d_way, l1_hit_now & ~icache)
    # the L1 line is invalidated on a miss before the L2 is consulted
    l1i_row = ca.row_invalidate(l1i_row, s_line, l1_miss & icache)
    l1d_row = ca.row_invalidate(l1d_row, s_line, l1_miss & ~icache)

    l2_hit_done_ps = (sclock + l1_tag + sync_l1_l2 + cc(CYC_L2_DAT)
                      + l1_dat)

    def l1_fill(row, mask, policy, ways):
        way, v_valid, v_line, _ = ca.row_pick_victim(row, policy, ways)
        return (ca.row_insert(row, s_line, way, l2_state, mask),
                v_valid & mask, v_line)

    l1i_row, l1i_ev, l1i_ev_line = l1_fill(
        l1i_row, l2_hit_now & icache, mp.l1i.replacement, ctx.l1i_ways)
    l1d_row, l1d_ev, l1d_ev_line = l1_fill(
        l1d_row, l2_hit_now & ~icache, mp.l1d.replacement,
        ctx.l1d_ways)
    # an L1 victim's cached-location in the L2 is cleared (the line stays
    # valid in the L2); looked up in the L2 as stored before this repeat
    l1_ev = l1i_ev | l1d_ev
    l1_ev_line = torch.where(l1i_ev, l1i_ev_line, l1d_ev_line)
    ev_hit, ev_way, _ = ca.lookup(ms.l2.meta, l1_ev_line, ctx.l2_sets)
    ev_sets = ca.set_index(l1_ev_line, ctx.l2_sets, nonneg=False)
    cloc = ms.l2_cloc
    cloc[tiles, ev_sets, ev_way] = torch.where(
        l1_ev & ev_hit, 0, cloc[tiles, ev_sets, ev_way])
    f_sets = l2_row.sets
    cloc[tiles, f_sets, l2_way] = torch.where(
        l2_hit_now, torch.where(icache, MOD_L1I, MOD_L1D).to(torch.uint8),
        cloc[tiles, f_sets, l2_way])
    if mp.l2.replacement != "round_robin":
        l2_row = ca.row_touch(l2_row, l2_way, l2_hit_now)

    req_send_ps = sclock + l1_tag + cc(CYC_L2_TAG)
    up_go = upgrade & ~stall_start
    l2_row = ca.row_invalidate(l2_row, s_line, up_go)
    if mp.l2.track_line_utilization:
        lu_cur = torch.gather(lu_row, 1, l2_way[:, None])[:, 0]
        lu_new = util_inc(lu_cur, s_write, l2_hit_now & enabled)
        lu_new = torch.where(up_go & enabled, 0, lu_new)
        ms.l2_util[tiles, f_sets, l2_way] = lu_new
        util_classify(cnt, lu_cur, up_go, enabled)
    ca.scatter_row(ms.l1i.meta, l1i_row)
    ca.scatter_row(ms.l1d.meta, l1d_row)
    ca.scatter_row(ms.l2.meta, l2_row)

    # upgrade: the L2 copy's eviction message to its home; then the
    # request, through the queues the evictions committed
    up_msg = torch.where(upgrade_dirty, MSG_FLUSH_REP, MSG_INV_REP)
    up_arr = net.send(ctx, ms, tiles, s_home, False, req_send_ps, up_go,
                      enabled, plain=True)
    for arr, val in ((mail.evict_type, up_msg.to(torch.uint8)),
                     (mail.evict_line, s_line),
                     (mail.evict_time, up_arr)):
        arr[s_home, tiles] = torch.where(up_go, val, arr[s_home, tiles])
    rq_arr = net.send(ctx, ms, tiles, s_home, False, req_send_ps,
                      l2_miss_go, enabled, plain=True)
    # the request, in the requester's own cells
    rq_type = torch.where(s_write, MSG_EX_REQ, MSG_SH_REQ).to(torch.uint8)
    mail.req_type.copy_(torch.where(l2_miss_go, rq_type, mail.req_type))
    mail.req_home.copy_(torch.where(l2_miss_go, s_home.to(torch.int32),
                                    mail.req_home))
    mail.req_line.copy_(torch.where(l2_miss_go, s_line, mail.req_line))
    mail.req_time.copy_(torch.where(l2_miss_go, rq_arr, mail.req_time))

    slot_done_now = ibuf_hit | l1_hit_now | l2_hit_now
    slot_done_ps = torch.where(
        ibuf_hit, clock + ccycles(1, fmhz, enabled),
        torch.where(l1_hit_now, l1_hit_done_ps, l2_hit_done_ps))
    lat = slot_done_ps - clock
    req.phase.copy_(torch.where(l2_miss_go, PHASE_WAIT_REPLY, req.phase))
    req.line.copy_(torch.where(l2_miss_go, s_line, req.line))
    req.is_write.copy_(torch.where(l2_miss_go, s_write, req.is_write))
    req.component.copy_(torch.where(
        l2_miss_go, torch.where(icache, MOD_L1I, MOD_L1D).to(torch.uint8),
        req.component))
    req.clock_ps.copy_(torch.where(l2_miss_go, req_send_ps, req.clock_ps))
    req.acc_ps.add_(torch.where(slot_done_now, lat, 0))
    k = torch.arange(3, device=dev)[None, :]
    req.slot_lat_ps.copy_(torch.where(
        slot_done_now[:, None] & (k == slot[:, None]), lat[:, None],
        req.slot_lat_ps))
    req.instr_buf.copy_(new_instr_buf)
    req.slot.copy_(torch.where(slot_done_now, slot + 1,
                               torch.where(starting, slot, req.slot)))

    # misses count only when they proceed (a lane stalled on a busy
    # eviction cell retries every iteration)
    miss_go = l1_miss & ~stall_start
    if mp.l2.track_miss_types:
        cls = l2_miss_go & enabled
        cnt.l2_capacity_misses.add_((cls & in_e).to(i64))
        cnt.l2_sharing_misses.add_((cls & ~in_e & (in_i | in_f)).to(i64))
        cnt.l2_cold_misses.add_((cls & ~in_e & ~in_i & ~in_f).to(i64))
        mt_update(ms.mt, MT_INVALIDATED, s_line, up_go, True)
    ws, rd = ~icache & s_write, ~icache & ~s_write
    cnt.l1i_hits.add_(((l1_hit_now | ibuf_hit) & icache & enabled).to(i64))
    cnt.l1i_misses.add_((miss_go & icache & enabled).to(i64))
    cnt.l1d_read_hits.add_((l1_hit_now & rd & enabled).to(i64))
    cnt.l1d_read_misses.add_((miss_go & rd & enabled).to(i64))
    cnt.l1d_write_hits.add_((l1_hit_now & ws & enabled).to(i64))
    cnt.l1d_write_misses.add_((miss_go & ws & enabled).to(i64))
    cnt.l2_hits.add_((l2_hit_now & enabled).to(i64))
    cnt.l2_misses.add_((l2_miss_go & enabled).to(i64))

    apply_functional(ctx, ms, rec, slot, s_addr, s_write,
                     slot_done_now & ~icache)
    return torch.sum(slot_done_now | l2_miss_go, dtype=torch.int32)


def mem_requester_plain(ctx: MemCtx, ms: MemState, rec: MemRec, clock,
                        fmhz, active, enabled, progress) -> None:
    for _ in range(max(int(ctx.mp.requester_unroll), 1)):
        progress.add_(requester_once(ctx, ms, rec, clock, fmhz, active,
                                     enabled))


def mem_requester(ctx: MemCtx, ms: MemState, lanes, trace, core, enabled,
                  progress, *, rec: "MemRec | None" = None) -> None:
    """Phase 1 in place on `ms`; adds its events to `progress`.  The CPU
    path takes `rec` (the lanes' records with their addresses)."""
    dev = core.clock_ps.device
    if dev.type == "cpu":
        if rec is None:
            rec = MemRec.fetch(lanes, trace, core.idx)
        mem_requester_plain(ctx, ms, rec, core.clock_ps,
                            core.freq_mhz.to(torch.int64), lanes.active,
                            enabled, progress)
        return
    if dev.type != "cuda":
        raise ValueError(f"mem_requester: unsupported device {dev}")
    KERNEL.launch_bound(*bound_args(ctx, ms, lanes, trace, core, enabled,
                                    progress))
