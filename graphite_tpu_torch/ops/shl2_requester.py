"""`shl2_requester`: phase 1 of the shared-L2 engine, the requesters' slot
starts (the app thread's L1-only path).

Replaces `_phase_requester` (`graphite_tpu/memory/engine_shl2.py:407-521`)
with `_apply_functional` (`:642-656`).  Kernel: `csrc/shl2_requester.cu`,
one CTA, one lane a thread, launched through a binding
(`build.Kernel.launch_bound`).

Per lane whose record has a slot left to start (active, requester idle):
the instruction-buffer fast path, the L1 lookup (L1-I for the icache
slot, else L1-D), under MESI the silent EXCLUSIVE -> MODIFIED promote of
a write hit, the LRU touch of a hit, on an L1 miss the SH / EX request to
the line's home slice (`line % T`) through the MEMORY net (the L1 stays
as it is: the fill replaces it), the slot bookkeeping, the L1 counters
and the functional store.  The L2 is not consulted here: every L1 miss
goes to the home.

As in `mem_requester`, the functional store is the only state two lanes
can write in one phase: the highest writing lane wins a word (the JAX
scatter's order on the CPU), and a checking load reads the word after
every store of the phase.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    U32, ccycles, next_present_slot, slots_present,
)
from graphite_tpu_torch.memory.context import (
    CYC_L1D_DAT, CYC_L1D_TAG, CYC_L1I_DAT, CYC_L1I_TAG, CYC_SYNC_CORE_L1D,
    MemCtx, MemRec,
)
from graphite_tpu_torch.memory.state import (
    MOD_L1D, MOD_L1I, MOD_NET_MEM, MSG_EX_REQ, MSG_SH_REQ, PHASE_IDLE,
    PHASE_WAIT_REPLY, ShL2State,
)
from graphite_tpu_torch.ops.build import Kernel, check_width
from graphite_tpu_torch.ops.mem_net_route import net_tensors, pack_with_net
from graphite_tpu_torch.ops.mem_requester import (
    MAX_TILES, apply_functional, engine_values,
)
from graphite_tpu_torch.trace.schema import FLAG_MEM0_WRITE, FLAG_MEM1_WRITE

_REQ = (("phase", torch.int32), ("slot", torch.int32),
        ("acc_ps", torch.int64), ("clock_ps", torch.int64),
        ("line", torch.int32), ("is_write", torch.bool),
        ("component", torch.uint8), ("instr_buf", torch.int32))
_COUNTERS = ("l1i_hits", "l1i_misses", "l1d_read_hits", "l1d_read_misses",
             "l1d_write_hits", "l1d_write_misses")


def shl2_values(ctx: MemCtx) -> tuple:
    """The plain values the shared-L2 kernels read before `MemConsts`
    (`Shl2Consts` in csrc/shl2_common.cuh): MESI, and the L1-D -> MEMORY
    net synchronization in cycles."""
    mp = ctx.mp
    return (int(mp.protocol.endswith("mesi")),
            mp.sync_cycles(MOD_L1D, MOD_NET_MEM))


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`Shl2ReqArgs` in
    csrc/shl2_requester.cu: the pointers, then the plain values)."""
    ctx, L = key
    mp = ctx.mp
    T = mp.n_tiles
    check_width("shl2_requester", T, MAX_TILES, "tiles")
    i64, i32, b, u8 = torch.int64, torch.int32, torch.bool, torch.uint8
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.flags", i32, t),
             ("lanes.pc", i64, t), ("lanes.aux0", i32, t),
             ("lanes.aux1", i32, t), ("lanes.active", b, t),
             ("trace.addr0", i64, (T, L)), ("trace.addr1", i64, (T, L)),
             ("core.idx", i32, t), ("core.clock_ps", i64, t),
             ("core.freq_mhz", i32, t), ("enabled", b, ()),
             ("progress", i32, (1,)), ("ctx.cyc", i64, (T, 11)),
             ("ctx.sets", i32, (3, T)),
             ("l1i.meta", i64, (T, mp.l1i.num_sets, mp.l1i.num_ways)),
             ("l1d.meta", i64, (T, mp.l1d.num_sets, mp.l1d.num_ways)),
             ("mail.req_type", u8, t), ("mail.req_home", i32, t),
             ("mail.req_line", i32, t), ("mail.req_time", i64, t)]
    specs += [(f"req.{n}", dt, t) for n, dt in _REQ]
    specs += [("req.slot_lat_ps", i64, (T, 3))]
    specs += [(f"counters.{n}", i64, t) for n in _COUNTERS]
    specs += [("func_mem", i64, (max(mp.func_mem_words, 1) + 1,)),
              ("func_errors", i64, ())]
    return pack_with_net(tensors, specs,
                         (L,) + shl2_values(ctx) + engine_values(ctx),
                         mp.net_hbh, mp.net_atac, T)


KERNEL = Kernel("shl2_requester", "gt_shl2_requester", pack=_pack)


def bound_args(ctx: MemCtx, ms: ShL2State, lanes, trace, core, enabled,
               progress) -> tuple:
    """The (tensors, key) a call binds, in `Shl2ReqArgs` order."""
    mail, req, cnt = ms.mail, ms.req, ms.counters
    return ((lanes.op, lanes.flags, lanes.pc, lanes.aux0, lanes.aux1,
             lanes.active, trace.addr0, trace.addr1, core.idx, core.clock_ps,
             core.freq_mhz, enabled, progress, ctx.cyc, ctx.sets,
             ms.l1i.meta, ms.l1d.meta, mail.req_type, mail.req_home,
             mail.req_line, mail.req_time,
             *(getattr(req, n) for n, _ in _REQ), req.slot_lat_ps,
             *(getattr(cnt, n) for n in _COUNTERS), ms.func_mem,
             ms.func_errors, *net_tensors(ctx.mp, ms.noc)),
            (ctx, trace.addr0.shape[1]))


def shl2_requester_plain(ctx: MemCtx, ms: ShL2State, rec: MemRec, clock,
                         fmhz, active, enabled, progress) -> None:
    """Phase 1 in place on `ms`; adds its events to `progress`."""
    mp = ctx.mp
    T = mp.n_tiles
    tiles = ctx.tiles
    i64 = torch.int64
    req, mail, cnt = ms.req, ms.mail, ms.counters
    cps = ctx.cycle_ps(fmhz, enabled)

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
    _, l1i_way, l1i_state = ca.row_lookup(l1i_row, s_line)
    _, l1d_way, l1d_state = ca.row_lookup(l1d_row, s_line)
    l1_state = torch.where(icache, l1i_state, l1d_state)
    l1_permit = torch.where(s_write, ca.state_writable(l1_state),
                            ca.state_readable(l1_state))
    do_l1 = starting & ~ibuf_hit
    l1_hit_now = do_l1 & l1_permit
    l1_miss = do_l1 & ~l1_permit

    l1_dat = torch.where(icache, cps[:, CYC_L1I_DAT], cps[:, CYC_L1D_DAT])
    l1_tag = torch.where(icache, cps[:, CYC_L1I_TAG], cps[:, CYC_L1D_TAG])
    # the core -> L1 sync is the L1-D's for both slot kinds (as in JAX)
    sclock = clock + cps[:, CYC_SYNC_CORE_L1D]
    l1_hit_done_ps = sclock + l1_dat

    # MESI: a write hit on EXCLUSIVE promotes to MODIFIED, no message
    promote = l1_hit_now & s_write & (l1_state == ca.EXCLUSIVE)
    l1d_row = ca.row_set_state(l1d_row, l1d_way, ca.MODIFIED,
                               promote & ~icache)
    if mp.l1i.replacement != "round_robin":
        l1i_row = ca.row_touch(l1i_row, l1i_way, l1_hit_now & icache)
    if mp.l1d.replacement != "round_robin":
        l1d_row = ca.row_touch(l1d_row, l1d_way, l1_hit_now & ~icache)
    ca.scatter_row(ms.l1i.meta, l1i_row)
    ca.scatter_row(ms.l1d.meta, l1d_row)

    # an L1 miss (an upgrade too) asks the line's home slice
    s_home = torch.remainder(s_line.to(i64), T)
    sync_l1_net = ccycles(mp.sync_cycles(MOD_L1D, MOD_NET_MEM), fmhz,
                          enabled)
    req_send_ps = sclock + l1_tag + sync_l1_net
    arrival = net.send(ctx, ms, tiles, s_home, False, req_send_ps, l1_miss,
                       enabled, plain=True)
    rq_type = torch.where(s_write, MSG_EX_REQ, MSG_SH_REQ).to(torch.uint8)
    mail.req_type.copy_(torch.where(l1_miss, rq_type, mail.req_type))
    mail.req_home.copy_(torch.where(l1_miss, s_home.to(torch.int32),
                                    mail.req_home))
    mail.req_line.copy_(torch.where(l1_miss, s_line, mail.req_line))
    mail.req_time.copy_(torch.where(l1_miss, arrival, mail.req_time))

    slot_done_now = ibuf_hit | l1_hit_now
    slot_done_ps = torch.where(ibuf_hit, clock + ccycles(1, fmhz, enabled),
                               l1_hit_done_ps)
    lat = slot_done_ps - clock
    req.phase.copy_(torch.where(l1_miss, PHASE_WAIT_REPLY, req.phase))
    req.line.copy_(torch.where(l1_miss, s_line, req.line))
    req.is_write.copy_(torch.where(l1_miss, s_write, req.is_write))
    req.component.copy_(torch.where(
        l1_miss, torch.where(icache, MOD_L1I, MOD_L1D).to(torch.uint8),
        req.component))
    req.clock_ps.copy_(torch.where(l1_miss, req_send_ps, req.clock_ps))
    req.acc_ps.add_(torch.where(slot_done_now, lat, 0))
    k = torch.arange(3, device=clock.device)[None, :]
    req.slot_lat_ps.copy_(torch.where(
        slot_done_now[:, None] & (k == slot[:, None]), lat[:, None],
        req.slot_lat_ps))
    req.instr_buf.copy_(new_instr_buf)
    req.slot.copy_(torch.where(slot_done_now, slot + 1,
                               torch.where(starting, slot, req.slot)))

    ws, rd = ~icache & s_write, ~icache & ~s_write
    cnt.l1i_hits.add_(((l1_hit_now | ibuf_hit) & icache & enabled).to(i64))
    cnt.l1i_misses.add_((l1_miss & icache & enabled).to(i64))
    cnt.l1d_read_hits.add_((l1_hit_now & rd & enabled).to(i64))
    cnt.l1d_read_misses.add_((l1_miss & rd & enabled).to(i64))
    cnt.l1d_write_hits.add_((l1_hit_now & ws & enabled).to(i64))
    cnt.l1d_write_misses.add_((l1_miss & ws & enabled).to(i64))
    progress.add_(torch.sum(slot_done_now | l1_miss, dtype=torch.int32))
    apply_functional(ctx, ms, rec, slot, s_addr, s_write, slot_done_now)


def shl2_requester(ctx: MemCtx, ms: ShL2State, lanes, trace, core, enabled,
                   progress, *, rec: "MemRec | None" = None) -> None:
    """Phase 1 in place on `ms`; adds its events to `progress`.  The CPU
    path takes `rec` (the lanes' records with their addresses)."""
    dev = core.clock_ps.device
    if dev.type == "cpu":
        if rec is None:
            rec = MemRec.fetch(lanes, trace, core.idx)
        shl2_requester_plain(ctx, ms, rec, core.clock_ps,
                             core.freq_mhz.to(torch.int64), lanes.active,
                             enabled, progress)
        return
    if dev.type != "cuda":
        raise ValueError(f"shl2_requester: unsupported device {dev}")
    KERNEL.launch_bound(*bound_args(ctx, ms, lanes, trace, core, enabled,
                                    progress))
