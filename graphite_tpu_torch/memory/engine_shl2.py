"""The shared-L2 protocol engine: `pr_l1_sh_l2_msi` and `_mesi`, with each
of the five directory schemes.

Port of `graphite_tpu/memory/engine_shl2.py` `shl2_engine_step`
(`:368-639`): private L1s over a DISTRIBUTED shared L2, the slice at a
line's home tile (`line % T`) holding the line and a directory entry over
its L1 copies (`ShL2State.dir`).  An L1 miss asks the home; the home
serves it from its slice (the directory FSM over the L1 sharers; MESI
grants EXCLUSIVE to a lone reader) or installs the line in DATA_INVALID
and fetches it from DRAM (`txn.dram_ready_ps`).  Any MEMORY net: magic or
emesh_hop_counter (zero-load), emesh_hop_by_hop or atac (every
coherence message through the net's own queues, `ShL2State.noc`).  One
call advances every tile by one subquantum iteration, in six phases,
each reading what the phase before it wrote:

    1 requester slot starts  kernel `shl2_requester`       (:407-521)
    2 sharer FWD service     PyTorch `sharer_step`         (:659-734)
    3 home evictions         PyTorch `home_evictions`      (:737-798)
    4 home acks + finish     PyTorch `home_finish`         (:801-930)
    5 home starts            kernel `shl2_home_start`      (:933-1138)
    6 requester fills        kernel `shl2_requester_fill`  (:1141-1230)

On the card phases 2-4 run as one CUDA graph of themselves
(`PhaseGraphs`); under a contention net it holds two launches of the
`mem_net_route` kernel (the acks, the replies), and the three kernels
route their own message sets.

Directory writes go to the store in place.  The JAX engine's row-delta
plans, gated conds and px exchanges (`:185-272`) only rearrange the same
writes for XLA, so the port has none of them.  Gating is the private
engine's (memory/engine.py): on the card every phase runs, its writes
masked by its own predicate; on the CPU the whole-engine gate and the
six phase predicates are evaluated as the JAX step does, and the skips
are counted in `ShL2State.phase_skips` (SHL2_PHASE_NAMES order; a
whole-engine skip counts as a skip of every phase).
"""

from __future__ import annotations

import numpy as np
import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    FAR, ccycles, clear_bit, next_present_slot, pack_bits, row_earliest,
    set_bit, shl2_entry, shl2_fields, shl2_rows, shl2_store, shl2_update,
    slots_present, test_bit,
)
from graphite_tpu_torch.memory.context import (
    CYC_L1D_DAT, CYC_L2_DAT, CYC_SYNC_L2_NET, MemCtx, MemRec,
)
from graphite_tpu_torch.memory.engine import protocol_live
from graphite_tpu_torch.memory.state import (
    DIR_EXCLUSIVE, DIR_MODIFIED, DIR_SHARED, DIR_UNCACHED, MOD_L1D,
    MOD_NET_MEM, MSG_EX_REP, MSG_EX_REQ, MSG_EXCL_REP, MSG_FLUSH_REP,
    MSG_FLUSH_REQ, MSG_INV_REP, MSG_INV_REQ, MSG_NONE, MSG_NULLIFY,
    MSG_SH_REP, MSG_SH_REQ, MSG_WB_REP, MSG_WB_REQ, PHASE_IDLE,
    PHASE_WAIT_REPLY, SHL2_OWNER_SHIFT, ShL2State,
)
from graphite_tpu_torch.ops import (
    shl2_home_start, shl2_requester, shl2_requester_fill,
)
from graphite_tpu_torch.ops.mem_home_start import send_reply


def sharer_step(ctx: MemCtx, ms: ShL2State, fmhz, enabled,
                progress) -> None:
    """Phase 2: each L1 serves its earliest FWD cell (INV / FLUSH / WB;
    `l1_cache_cntlr.cc` handlers)."""
    tiles = ctx.tiles
    i64 = torch.int64
    mail = ms.mail

    h, found = row_earliest(mail.fwd_type, mail.fwd_time)
    ftype = mail.fwd_type[tiles, h]
    fline = mail.fwd_line[tiles, h]
    ftime = mail.fwd_time[tiles, h]

    l1i_r = ca.gather_row(ms.l1i.meta, fline, ctx.l1i_sets)
    l1d_r = ca.gather_row(ms.l1d.meta, fline, ctx.l1d_sets)
    l1i_hit, l1i_way, l1i_state = ca.row_lookup(l1i_r, fline)
    l1d_hit, l1d_way, l1d_state = ca.row_lookup(l1d_r, fline)
    serve = found & (l1i_hit | l1d_hit)
    was_dirty = ((l1d_hit & (l1d_state == ca.MODIFIED))
                 | (l1i_hit & (l1i_state == ca.MODIFIED)))
    is_inv = ftype == MSG_INV_REQ
    is_wb = ftype == MSG_WB_REQ
    done_ps = (ftime + ccycles(ctx.mp.sync_cycles(MOD_L1D, MOD_NET_MEM),
                               fmhz, enabled)
               + ctx.cycle_ps(fmhz, enabled)[:, CYC_L1D_DAT])

    inv_do = serve & ~is_wb
    l1i_r = ca.row_invalidate(l1i_r, fline, inv_do & l1i_hit)
    l1d_r = ca.row_invalidate(l1d_r, fline, inv_do & l1d_hit)
    # WB downgrades M / E to SHARED (the data goes back)
    l1i_r = ca.row_set_state(l1i_r, l1i_way, ca.SHARED,
                             serve & is_wb & l1i_hit)
    l1d_r = ca.row_set_state(l1d_r, l1d_way, ca.SHARED,
                             serve & is_wb & l1d_hit)
    ca.scatter_row(ms.l1i.meta, l1i_r)
    ca.scatter_row(ms.l1d.meta, l1d_r)

    # FLUSH_REP when dirty data travels, else INV_REP / WB_REP (a FLUSH
    # of a clean line carries no data: INV_REP)
    ack = torch.where(is_inv, MSG_INV_REP, torch.where(
        is_wb, torch.where(was_dirty, MSG_FLUSH_REP, MSG_WB_REP),
        MSG_FLUSH_REP))
    ack = torch.where((ftype == MSG_FLUSH_REQ) & ~was_dirty, MSG_INV_REP, ack)
    arrival = net.send(ctx, ms, tiles, h, ack != MSG_INV_REP, done_ps, serve,
                       enabled)
    for arr, val in ((mail.ack_type, ack.to(torch.uint8)),
                     (mail.ack_line, fline), (mail.ack_time, arrival)):
        arr[h, tiles] = torch.where(serve, val, arr[h, tiles])
    mail.fwd_type[tiles, h] = torch.where(found, MSG_NONE, ftype).to(
        torch.uint8)
    ms.counters.invalidations.add_((serve & is_inv & enabled).to(i64))
    progress.add_(torch.sum(found, dtype=torch.int32))


def home_evictions(ctx: MemCtx, ms: ShL2State, cps, enabled,
                   progress) -> None:
    """Phase 3: each home consumes its earliest L1 eviction notice (the
    embedded directory drops the sender; a dirty flush turns the slice's
    line MODIFIED with respect to DRAM)."""
    tiles = ctx.tiles
    i64 = torch.int64
    mail, txn = ms.mail, ms.txn

    src, found = row_earliest(mail.evict_type, mail.evict_time)
    etype = mail.evict_type[tiles, src]
    eline = mail.evict_line[tiles, src]
    etime = mail.evict_time[tiles, src]

    l2r = ca.gather_row(ms.l2.meta, eline, ctx.l2_sets, nonneg=False)
    dw, dsh = shl2_rows(ms.dir, l2r.sets, tiles)
    l2_hit, l2_way, _ = ca.row_lookup(l2r, eline)
    apply = found & l2_hit
    word, sharers = shl2_entry(dw, dsh, l2_way)
    _, owner, nsh = shl2_fields(word)
    was_sharer = test_bit(sharers, src)
    new_nsh = nsh - (apply & was_sharer).to(i64)
    is_flush = etype == MSG_FLUSH_REP
    shl2_update(dw, dsh, l2_way, apply,
                dstate=torch.where(new_nsh == 0, DIR_UNCACHED, DIR_SHARED),
                owner=torch.where(src == owner, -1, owner),
                nsharers=new_nsh, sharers=clear_bit(sharers, src, apply))
    shl2_store(ms.dir, l2r.sets, tiles, dw, dsh)
    ca.scatter_row(ms.l2.meta, ca.row_set_state(l2r, l2_way, ca.MODIFIED,
                                                apply & is_flush))

    # an active same-line transaction takes the eviction as its ack
    txn_match = txn.active & found & (txn.line == eline)
    txn.pending.copy_(clear_bit(txn.pending, src, txn_match))
    txn.time_ps.copy_(torch.where(
        txn_match, torch.maximum(txn.time_ps, etime + cps[:, CYC_L2_DAT]),
        txn.time_ps))
    txn.got_flush.copy_(txn.got_flush | (txn_match & is_flush))
    mail.evict_type[tiles, src] = torch.where(found, MSG_NONE, etype).to(
        torch.uint8)
    ms.counters.evictions.add_((found & enabled).to(i64))
    progress.add_(torch.sum(found, dtype=torch.int32))


def home_finish(ctx: MemCtx, ms: ShL2State, cps, enabled,
                progress) -> None:
    """Phase 4: each home consumes the acks of its transaction and its
    DRAM arrival, then finishes a transaction with nothing pending (the
    directory entry, the reply)."""
    mp = ctx.mp
    tiles = ctx.tiles
    i64 = torch.int64
    mail, txn = ms.mail, ms.txn
    l2_access = cps[:, CYC_L2_DAT]
    mesi = mp.protocol.endswith("mesi")

    match = ((mail.ack_type != MSG_NONE) & txn.active[:, None]
             & (mail.ack_line == txn.line[:, None]))
    any_match = match.any(dim=1)
    max_ack = torch.where(match, mail.ack_time, 0).max(dim=1).values
    got_flush = (match & (mail.ack_type == MSG_FLUSH_REP)).any(dim=1)
    # the acked bits, padded to SW * 32 (`:816-822`)
    txn.pending.copy_(txn.pending & ~pack_bits(match, mp.sharer_words))
    txn.time_ps.copy_(torch.where(
        any_match, torch.maximum(txn.time_ps, max_ack + l2_access),
        txn.time_ps))
    txn.got_flush.copy_(txn.got_flush | got_flush)
    mail.ack_type.zero_()

    l2r = ca.gather_row(ms.l2.meta, txn.line, ctx.l2_sets, nonneg=False)
    sets = l2r.sets
    dw, dsh = shl2_rows(ms.dir, sets, tiles)

    # the DRAM arrival fills the slice's line in SHARED
    no_acks = (txn.pending == 0).all(dim=1)
    dram_in = txn.active & (txn.dram_ready_ps < FAR) & no_acks
    l2_hit, l2_way, _ = ca.row_lookup(l2r, txn.line)
    l2r = ca.row_set_state(l2r, l2_way, ca.SHARED, dram_in & l2_hit)
    txn.time_ps.copy_(torch.where(
        dram_in, torch.maximum(txn.time_ps, txn.dram_ready_ps),
        txn.time_ps))
    txn.dram_ready_ps.copy_(torch.where(dram_in, FAR, txn.dram_ready_ps))

    finish = txn.active & no_acks & (txn.dram_ready_ps >= FAR)
    mtype = txn.mtype.to(i64)
    is_ex = mtype == MSG_EX_REQ
    is_sh = mtype == MSG_SH_REQ
    is_nullify = mtype == MSG_NULLIFY
    _, l2_way, l2_state = ca.row_lookup(l2r, txn.line)
    r = txn.requester.to(i64)
    rbit = set_bit(torch.zeros_like(txn.pending), r, finish)
    word, sharers = shl2_entry(dw, dsh, l2_way)
    _, _, nsh = shl2_fields(word)

    # flushed data lands in the slice
    l2r = ca.row_set_state(l2r, l2_way, ca.MODIFIED,
                           finish & txn.got_flush & ~is_nullify)
    # EX: MODIFIED, owner r, sharers {r}
    exf = finish & is_ex
    shl2_update(dw, dsh, l2_way, exf, dstate=DIR_MODIFIED, owner=r,
                nsharers=1, cloc=txn.req_comp, sharers=rbit)
    # SH: r joins; MESI grants EXCLUSIVE when no other sharer is left
    shf = finish & is_sh
    had = test_bit(sharers, r)
    excl = shf & ((nsh - had.to(i64)) == 0) & mesi
    shl2_update(dw, dsh, l2_way, shf,
                dstate=torch.where(excl, DIR_EXCLUSIVE, DIR_SHARED),
                owner=torch.where(excl, r, -1),
                nsharers=nsh + (~had).to(i64), cloc=txn.req_comp,
                sharers=sharers | rbit)
    # NULLIFY: the entry dies; dirty data (slice M or flushed) -> DRAM
    nlf = finish & is_nullify
    wb_dram = nlf & ((l2_state == ca.MODIFIED) | txn.got_flush)
    l2r = ca.row_invalidate(l2r, txn.line, nlf)
    shl2_update(dw, dsh, l2_way, nlf, dstate=DIR_UNCACHED, owner=-1,
                nsharers=0, sharers=torch.zeros_like(txn.pending))
    ca.scatter_row(ms.l2.meta, l2r)
    shl2_store(ms.dir, sets, tiles, dw, dsh)

    # the reply (the slice access was charged at the start); the adds
    # into the reply cells are the JAX scatter-adds: a lane that does not
    # reply adds 0 into cell 0
    rep_ready = txn.time_ps + cps[:, CYC_SYNC_L2_NET]
    rep_msg = torch.where(exf, MSG_EX_REP,
                          torch.where(excl, MSG_EXCL_REP, MSG_SH_REP))
    rep_go = finish & ~is_nullify
    arrival = net.send(ctx, ms, tiles, r, True, rep_ready, rep_go, enabled)
    send_reply(mail, r, rep_go, rep_msg, arrival)
    mail.fwd_type.copy_(torch.where(finish[None, :], MSG_NONE,
                                    mail.fwd_type))
    txn.active.copy_(txn.active & ~finish)
    txn.got_flush.copy_(txn.got_flush & ~finish)
    txn.last_line.copy_(torch.where(finish, txn.line, txn.last_line))
    txn.last_done_ps.copy_(torch.where(finish, rep_ready, txn.last_done_ps))
    ms.counters.dram_writes.add_((wb_dram & enabled).to(i64))
    progress.add_(torch.sum(finish, dtype=torch.int32)
                  + torch.sum(any_match | dram_in, dtype=torch.int32))


def shl2_live(ms: ShL2State) -> torch.Tensor:
    """Any protocol state outstanding, in-flight DRAM fetches included
    (`:626-629`)."""
    return protocol_live(ms) | (ms.txn.dram_ready_ps < FAR).any()


def shl2_graph_phases(ctx: MemCtx, enabled, freq) -> tuple:
    """The card's one CUDA graph of the plain phases 2-4."""
    def middle(m, p):
        fmhz = freq.to(torch.int64)
        cps = ctx.cycle_ps(freq, enabled)
        sharer_step(ctx, m, fmhz, enabled, p)
        home_evictions(ctx, m, cps, enabled, p)
        home_finish(ctx, m, cps, enabled, p)

    return (middle,)


def shl2_engine_step(ctx: MemCtx, ms: ShL2State, lanes, trace, core,
                     enabled, progress, mem_ok) -> None:
    """One engine iteration in place on `ms`: adds the protocol events to
    `progress` and writes `mem_ok` (every slot of each lane's record
    complete).  Reads the pre-commit core clock and frequency.  See the
    module doc for the card and CPU paths."""
    if core.idx.device.type != "cpu":
        graphs = ctx.phase_graphs
        (middle,) = graphs.get(ctx, ms, enabled, core.freq_mhz, progress)
        shl2_requester(ctx, ms, lanes, trace, core, enabled, progress)
        graphs.replay(middle)
        shl2_home_start(ctx, ms, core.freq_mhz, enabled, progress)
        shl2_requester_fill(ctx, ms, lanes, trace, core, enabled, progress,
                            mem_ok)
        return
    rec = MemRec.fetch(lanes, trace, core.idx)
    present = slots_present(ctx.mp, rec.op, rec.flags, enabled)
    req, mail, txn = ms.req, ms.mail, ms.txn
    fmhz = core.freq_mhz.to(torch.int64)
    if not bool(shl2_live(ms) | (lanes.active & present.any(dim=1)).any()):
        ms.phase_skips.add_(1)
        mem_ok.copy_((req.phase == PHASE_IDLE)
                     & (next_present_slot(present, req.slot) >= 3))
        return
    cps = ctx.cycle_ps(fmhz, enabled)
    preds = []

    def gate(pred) -> bool:
        preds.append(bool(pred))
        return preds[-1]

    if gate((lanes.active & (req.phase == PHASE_IDLE)
             & (next_present_slot(present, req.slot) < 3)).any()):
        shl2_requester(ctx, ms, lanes, trace, core, enabled, progress,
                       rec=rec)
    if gate((mail.fwd_type != MSG_NONE).any()):
        sharer_step(ctx, ms, fmhz, enabled, progress)
    if gate((mail.evict_type != MSG_NONE).any()):
        home_evictions(ctx, ms, cps, enabled, progress)
    if gate((mail.ack_type != MSG_NONE).any() | txn.active.any()):
        home_finish(ctx, ms, cps, enabled, progress)
    if gate((mail.req_type != MSG_NONE).any()
            | (txn.saved_valid & ~txn.active).any()):
        shl2_home_start(ctx, ms, core.freq_mhz, enabled, progress)
    if gate(((req.phase == PHASE_WAIT_REPLY)
             & (mail.rep_type != MSG_NONE)).any()):
        shl2_requester_fill(ctx, ms, lanes, trace, core, enabled, progress,
                            mem_ok, rec=rec)
    else:
        mem_ok.copy_((req.phase == PHASE_IDLE)
                     & (next_present_slot(present, req.slot) >= 3))
    ms.phase_skips.add_(1 - torch.tensor(preds, dtype=torch.int64))


# ---------------------------------------------------------------------------
# host-side census


def shl2_line_census(ms: ShL2State, mp, lines) -> dict:
    """Per-line coherence view of a ShL2State (`engine_shl2.py:1238`):
    per line, the L1-I and L1-D state on every tile, the home slice's
    data state, and the embedded directory entry (dstate, owner,
    frozenset of sharers) at the slice way holding the line, or None."""
    metas = {n: getattr(ms, n).meta.cpu().numpy() for n in ("l1i", "l1d",
                                                            "l2")}
    word = ms.dir.word.cpu().numpy()
    sharers = ms.dir.sharers.cpu().numpy()
    T = mp.n_tiles
    sw = mp.sharer_words
    tags = {n: (m >> 16).astype(np.int32) for n, m in metas.items()}
    states = {n: ((m >> 8) & 0xFF).astype(np.int64)
              for n, m in metas.items()}

    def cache_state(n, t, line):
        s = line % tags[n].shape[1]
        hit = tags[n][t, s, :] == line
        return int(states[n][t, s, hit.argmax()]) if hit.any() else 0

    out = {}
    for line in lines:
        home = line % T
        sset = line % tags["l2"].shape[1]
        slice_st = 0
        dent = None
        hit = tags["l2"][home, sset, :] == line
        if hit.any():
            way = int(hit.argmax())
            slice_st = int(states["l2"][home, sset, way])
            w = int(word[home, sset, way])
            owner = ((w >> SHL2_OWNER_SHIFT) & ((1 << 13) - 1)) - 1
            bits = sharers[home, sset, way * sw:(way + 1) * sw]
            shset = frozenset(
                i * 32 + b for i in range(sw) for b in range(32)
                if (int(bits[i]) >> b) & 1)
            dent = (int(w & 7), int(owner), shset)
        out[line] = {
            "l1i": tuple(cache_state("l1i", t, line) for t in range(T)),
            "l1d": tuple(cache_state("l1d", t, line) for t in range(T)),
            "slice": slice_st,
            "dir": dent,
        }
    return out
