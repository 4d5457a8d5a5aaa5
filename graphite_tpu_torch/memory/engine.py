"""The private-L1/L2 directory protocol engine: MSI and MOSI, with each
of the five directory schemes.

Port of `graphite_tpu/memory/engine.py` `memory_engine_step`
(`:1312-1845`) for `pr_l1_pr_l2_dram_directory_msi` and `_mosi` with a
`full_map`, `limited_no_broadcast`, `ackwise`, `limited_broadcast` or
`limitless` directory (the sharer list stays exact in every scheme: the
schemes differ in the messages they send and what those cost) over any
MEMORY network: magic or emesh_hop_counter (zero-load),
emesh_hop_by_hop or atac (every coherence message routed through the
net's own queues, `MemState.noc`; memory/net.py).  One call advances
every tile's memory machinery by one subquantum iteration, in six
phases, each reading what the phase before it wrote:

    1 requester slot starts   kernel `mem_requester`       (:1378-1688)
    2 home evictions          PyTorch `home_evictions`     (:2006-2078)
    3 home transaction starts kernel `mem_home_start`      (:2219-2546)
    4 sharer FWD service      PyTorch `sharer_step`        (:1870-2005)
    5 home acks + finish      PyTorch `home_acks_and_finish` (:2079-2218)
    6 requester fills         kernel `mem_requester_fill`  (:2547-2712)

On the card the PyTorch phases run as CUDA graphs of themselves
(`PhaseGraphs`); under a contention net the graph of phases 4-5 holds
two launches of the `mem_net_route` kernel (the acks, the replies), and
the three kernels route their own message sets.

Directory writes go to the store in place.  The JAX engine's working-set
gather, delta plans and staging (`:720-1310`) only rearrange the same
writes around XLA's scatter costs and are bit-exact by construction, so
the port has none of them.

Gating.  The JAX step skips the whole engine when no protocol state is
live and no active lane has a memory slot (`mem_gate`,
`graphite_tpu/engine/step.py:316-331`), and each phase when its
predicate is false (`phase_gate`).  Every phase is the identity when its
predicate is false (each write is masked by the very condition the
predicate ORs over), so on the card the port evaluates no predicate on
the host: a kernel's thread finds nothing to do for its lane, and the
plain phases run their masked arithmetic.  On the CPU both gates are
evaluated as the JAX step does (a host read is free there).  The tests
hold JAX runs with both gates off to the gated default, and chip_smoke
holds the ungated card run to the gated CPU run.
"""

from __future__ import annotations

import weakref

import torch

from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import net
from graphite_tpu_torch.memory.common import (
    clear_bit, dir_nsh, dir_owner, dir_state, gated, mt_update,
    next_present_slot, pack_bits, row_earliest, set_bit, slots_present,
    test_bit, util_classify,
)
from graphite_tpu_torch.memory.context import (
    CYC_L1D_TAG, CYC_L2_DAT, CYC_L2_TAG, CYC_SYNC_L1D_L2, CYC_SYNC_L2_NET,
    MemCtx, MemRec,
)
from graphite_tpu_torch.memory.state import (
    DIR_ID_BITS, DIR_MODIFIED, DIR_OWNED, DIR_OWNER_SHIFT, DIR_SHARED,
    DIR_STATE_SHIFT, DIR_TAG_BITS, DIR_UNCACHED, MOD_L1D, MOD_L1I,
    MSG_EX_REP, MSG_EX_REQ, MSG_FLUSH_REP, MSG_FLUSH_REQ, MSG_INV_REP,
    MSG_INV_REQ, MSG_NONE, MSG_NULLIFY, MSG_SH_REP, MSG_SH_REQ, MSG_WB_REP,
    MSG_WB_REQ, MT_INVALIDATED, PHASE_IDLE, PHASE_WAIT_REPLY, MemState,
)
from graphite_tpu_torch.ops import (
    mem_home_start, mem_requester, mem_requester_fill,
)
from graphite_tpu_torch.ops.mem_home_start import (
    dir_view, dir_write, send_reply,
)


def home_evictions(ctx: MemCtx, ms: MemState, enabled, progress) -> None:
    """Phase 2: each home consumes its earliest EVICT cell."""
    tiles = ctx.tiles
    i64 = torch.int64
    mail, txn = ms.mail, ms.txn
    dir_access = gated(ctx.timing.dir_access_ps, enabled)

    src, found = row_earliest(mail.evict_type, mail.evict_time)
    etype = mail.evict_type[tiles, src]
    eline = mail.evict_line[tiles, src]
    etime = mail.evict_time[tiles, src]

    sets, words, sh, dfound, way = dir_view(ms, eline, tiles)
    apply = found & dfound
    word = torch.gather(words, 1, way[:, None])[:, 0]
    sharers = sh[tiles, way]
    dstate, owner, nsh = dir_state(word), dir_owner(word), dir_nsh(word)
    was_sharer = test_bit(sharers, src)
    new_nsh = nsh - (apply & was_sharer).to(torch.int32)
    is_flush = etype == MSG_FLUSH_REP
    dir_write(ms, tiles, sets, way, apply,
              dstate=torch.where(new_nsh == 0, DIR_UNCACHED,
                                 torch.where(is_flush, DIR_SHARED, dstate)),
              owner=torch.where(is_flush, -1, owner),
              sharers=clear_bit(sharers, src, apply), nsharers=new_nsh)

    # an active same-line transaction takes the eviction as its ack
    txn_match = txn.active & found & (txn.line == eline)
    txn.pending.copy_(clear_bit(txn.pending, src, txn_match))
    txn.time_ps.copy_(torch.where(
        txn_match, torch.maximum(txn.time_ps, etime + dir_access),
        txn.time_ps))
    txn.data_cached.copy_(txn.data_cached | (txn_match & is_flush))
    # flushed data parks in the home's one-entry buffer
    txn.cdata_line.copy_(torch.where(found & is_flush, eline,
                                     txn.cdata_line))
    txn.cdata_valid.copy_(txn.cdata_valid | (found & is_flush))

    mail.evict_type[tiles, src] = torch.where(
        found, MSG_NONE, etype).to(torch.uint8)
    cnt = ms.counters
    cnt.evictions.add_((found & enabled).to(i64))
    cnt.dram_writes.add_((found & is_flush & enabled).to(i64))
    progress.add_(torch.sum(found, dtype=torch.int32))


def sharer_step(ctx: MemCtx, ms: MemState, cps, enabled, progress) -> None:
    """Phase 4: each tile serves its earliest FWD cell (INV / FLUSH / WB).
    `cps` is `ctx.cycle_ps` of this iteration."""
    mp = ctx.mp
    tiles = ctx.tiles
    i64 = torch.int64
    mail = ms.mail

    h, found = row_earliest(mail.fwd_type, mail.fwd_time)
    ftype = mail.fwd_type[tiles, h]
    fline = mail.fwd_line[tiles, h]
    ftime = mail.fwd_time[tiles, h]

    l2_r = ca.gather_row(ms.l2.meta, fline, ctx.l2_sets)
    l1i_r = ca.gather_row(ms.l1i.meta, fline, ctx.l1i_sets)
    l1d_r = ca.gather_row(ms.l1d.meta, fline, ctx.l1d_sets)
    l2_hit, l2_way, l2_state = ca.row_lookup(l2_r, fline)
    serve = found & l2_hit & (l2_state != ca.INVALID)

    is_inv = ftype == MSG_INV_REQ
    l2_cost = torch.where(is_inv, cps[:, CYC_L2_TAG], cps[:, CYC_L2_DAT])
    done_ps = (ftime + cps[:, CYC_SYNC_L2_NET] + l2_cost
               + cps[:, CYC_L1D_TAG] + 2 * cps[:, CYC_SYNC_L1D_L2])

    sets = l2_r.sets
    way64 = l2_way.to(i64)
    cloc = ms.l2_cloc[tiles, sets, way64]
    inv_l1 = serve & (ftype != MSG_WB_REQ)
    wb_l1 = serve & (ftype == MSG_WB_REQ)
    l1i_r = ca.row_invalidate(l1i_r, fline, inv_l1 & (cloc == MOD_L1I))
    l1d_r = ca.row_invalidate(l1d_r, fline, inv_l1 & (cloc == MOD_L1D))
    l1i_hit, l1i_way, _ = ca.row_lookup(l1i_r, fline)
    l1d_hit, l1d_way, _ = ca.row_lookup(l1d_r, fline)
    # WB downgrade: MSI M -> SHARED; MOSI M -> OWNED, O -> O, S -> S
    # (the owner keeps the dirty line)
    wb_state = (torch.where(l2_state == ca.MODIFIED, ca.OWNED, l2_state)
                if mp.is_mosi else ca.SHARED)
    l1i_r = ca.row_set_state(l1i_r, l1i_way, wb_state,
                             wb_l1 & (cloc == MOD_L1I) & l1i_hit)
    l1d_r = ca.row_set_state(l1d_r, l1d_way, wb_state,
                             wb_l1 & (cloc == MOD_L1D) & l1d_hit)
    ca.scatter_row(ms.l1i.meta, l1i_r)
    ca.scatter_row(ms.l1d.meta, l1d_r)
    l2_r = ca.row_invalidate(l2_r, fline, inv_l1)
    l2_r = ca.row_set_state(l2_r, l2_way, wb_state, wb_l1)
    ca.scatter_row(ms.l2.meta, l2_r)
    if mp.l2.track_line_utilization:
        lu_cur = ms.l2_util[tiles, sets, way64]
        ms.l2_util[tiles, sets, way64] = torch.where(inv_l1 & enabled, 0,
                                                     lu_cur)
        util_classify(ms.counters, lu_cur, inv_l1, enabled)
    if mp.l2.track_miss_types:
        mt_update(ms.mt, MT_INVALIDATED, fline, inv_l1, True)
    ms.l2_cloc[tiles, sets, way64] = torch.where(inv_l1, 0, cloc)

    # the ack to the home (INV acks are header-only; FLUSH/WB carry data)
    ack = torch.where(is_inv, MSG_INV_REP, torch.where(
        ftype == MSG_FLUSH_REQ, MSG_FLUSH_REP, MSG_WB_REP))
    arrival = net.send(ctx, ms, tiles, h, ~is_inv, done_ps, serve, enabled)
    for arr, val in ((mail.ack_type, ack.to(torch.uint8)),
                     (mail.ack_line, fline), (mail.ack_time, arrival)):
        arr[h, tiles] = torch.where(serve, val, arr[h, tiles])
    mail.fwd_type[tiles, h] = torch.where(found, MSG_NONE, ftype).to(
        torch.uint8)
    ms.counters.invalidations.add_((serve & is_inv & enabled).to(i64))
    progress.add_(torch.sum(found, dtype=torch.int32))


def home_acks_and_finish(ctx: MemCtx, ms: MemState, enabled,
                         progress) -> None:
    """Phase 5: each home consumes every ack of its transaction, then
    finishes a transaction with no ack pending."""
    mp = ctx.mp
    tiles = ctx.tiles
    i64 = torch.int64
    mail, txn = ms.mail, ms.txn
    dram_lat = gated(ctx.timing.dram_lat_ps, enabled)
    dir_access = gated(ctx.timing.dir_access_ps, enabled)

    match = ((mail.ack_type != MSG_NONE) & txn.active[:, None]
             & (mail.ack_line == txn.line[:, None]))
    any_match = match.any(dim=1)
    max_ack = torch.where(match, mail.ack_time, 0).max(dim=1).values
    got_data = (match & ((mail.ack_type == MSG_FLUSH_REP)
                         | (mail.ack_type == MSG_WB_REP))).any(dim=1)
    wb_any = (match & (mail.ack_type == MSG_WB_REP)).any(dim=1)
    txn.pending.copy_(txn.pending & ~pack_bits(match, mp.sharer_words))
    txn.time_ps.copy_(torch.where(
        any_match, torch.maximum(txn.time_ps, max_ack + dir_access),
        txn.time_ps))
    txn.data_cached.copy_(txn.data_cached | got_data)
    # every ack cell is dropped (matched = consumed, stale = dropped)
    mail.ack_type.zero_()

    finish = txn.active & (txn.pending == 0).all(dim=1)
    mtype = txn.mtype.to(i64)
    is_ex = mtype == MSG_EX_REQ
    is_sh = mtype == MSG_SH_REQ
    is_nullify = mtype == MSG_NULLIFY
    sets, words, sh, dfound, way = dir_view(ms, txn.line, tiles)
    r = txn.requester.to(i64)
    rbit = set_bit(torch.zeros_like(txn.pending), r, finish)
    exf = finish & is_ex & dfound
    shf = finish & is_sh & dfound
    cur_word = torch.gather(words, 1, way[:, None])[:, 0]
    cur_nsh = dir_nsh(cur_word)
    cur_sh = sh[tiles, way]
    had = test_bit(cur_sh, r)
    # EX: M, owner r, sharers {r}; SH: r joins, and the entry turns
    # SHARED without owner (MSI: the WB data went through to DRAM), or
    # under MOSI a dirty entry (M / O) turns OWNED, its owner kept
    sh_dstate, sh_owner = DIR_SHARED, -1
    if mp.is_mosi:
        cur_dstate = dir_state(cur_word)
        from_dirty = (cur_dstate == DIR_MODIFIED) | (cur_dstate == DIR_OWNED)
        sh_dstate = torch.where(from_dirty, DIR_OWNED, DIR_SHARED)
        sh_owner = torch.where(from_dirty, dir_owner(cur_word), -1)
    dir_write(ms, tiles, sets, way, exf | shf,
              dstate=torch.where(exf, DIR_MODIFIED, sh_dstate),
              owner=torch.where(exf, r, sh_owner),
              sharers=torch.where(exf[:, None], rbit,
                                  set_bit(cur_sh, r, shf)),
              nsharers=torch.where(exf, 1,
                                   cur_nsh + (~had).to(torch.int32)))

    # the reply (DRAM only when no FLUSH/WB or buffered data came back)
    cdata_hit = txn.cdata_valid & (txn.cdata_line == txn.line)
    need_dram = finish & ~(txn.data_cached | cdata_hit) & ~is_nullify
    rep_ready = txn.time_ps + torch.where(need_dram, dram_lat, 0)
    rep_go = finish & ~is_nullify
    arrival = net.send(ctx, ms, tiles, r, True, rep_ready, rep_go, enabled)
    send_reply(mail, r, rep_go, torch.where(is_ex, MSG_EX_REP, MSG_SH_REP),
               arrival)
    # clear the home's FWD column: no stale multicast leaks onward
    mail.fwd_type.copy_(torch.where(finish[None, :], MSG_NONE,
                                    mail.fwd_type))
    txn.active.copy_(txn.active & ~finish)
    txn.last_line.copy_(torch.where(finish, txn.line, txn.last_line))
    txn.last_done_ps.copy_(torch.where(finish, rep_ready,
                                       txn.last_done_ps))
    txn.cdata_valid.copy_(txn.cdata_valid & ~(finish & cdata_hit))
    cnt = ms.counters
    cnt.dram_reads.add_((need_dram & enabled).to(i64))
    # MOSI keeps WB data dirty at the owner: DRAM is written only when
    # a dirty line is evicted or flushed
    if not mp.is_mosi:
        cnt.dram_writes.add_((wb_any & enabled).to(i64))
    cnt.dram_total_lat_ps.add_(torch.where(need_dram & enabled, dram_lat,
                                           0))
    progress.add_(torch.sum(finish, dtype=torch.int32)
                  + torch.sum(any_match, dtype=torch.int32))


def protocol_live(ms: MemState) -> torch.Tensor:
    """Any protocol state outstanding (`engine.py:629-648`)."""
    mail = ms.mail
    return ((mail.req_type != MSG_NONE).any()
            | (mail.evict_type != MSG_NONE).any()
            | (mail.fwd_type != MSG_NONE).any()
            | (mail.ack_type != MSG_NONE).any()
            | (mail.rep_type != MSG_NONE).any()
            | ms.txn.active.any() | ms.txn.saved_valid.any()
            | (ms.req.phase != PHASE_IDLE).any())


class PhaseGraphs:
    """Phases 2 and 4-5 on the card as two CUDA graphs of their plain
    versions, captured on the first iteration of a state and replayed
    every iteration: one host launch each instead of ~200 and ~450
    PyTorch launches (the plain phases' host time set the pace of every
    memory run).  The graphs hold the addresses of the state's tensors,
    the models-enabled flag, the core frequencies and the progress
    counter: a call with any other object (a cloned state, another lane
    scratch) captures anew, and nothing here keeps an old one alive (weak
    references).  The port never re-points a state tensor in place.
    Capture runs each phase once on a copy of the state first (loading
    every kernel the graph will hold); the capture itself computes
    nothing, the replay does.

    A kernel launch recorded in a graph runs at each replay, not at
    capture: `replay` adds each graph's recorded launches to the
    kernels' counts (`ops.KERNELS`); `replays` counts the host's graph
    launches and `captures` the states captured."""

    def __init__(self, phases=None):
        # (ctx, enabled, freq) -> the functions fn(ms, progress) captured,
        # one graph each (`graph_phases`; the shared-L2 engine's
        # `engine_shl2.shl2_graph_phases`)
        self.phases = phases or graph_phases
        self.refs = ()
        self.graphs = None
        self.replays = 0
        self.captures = 0

    def get(self, ctx, ms, enabled, freq, progress):
        objs = (ms, enabled, freq, progress)
        if (len(self.refs) != len(objs)
                or any(r() is not o for r, o in zip(self.refs, objs))):
            self.graphs = None
            self.graphs = tuple(_capture(ms, progress, fn)
                                for fn in self.phases(ctx, enabled, freq))
            self.refs = tuple(map(weakref.ref, objs))
            self.captures += 1
        return self.graphs

    def replay(self, captured) -> None:
        graph, launches = captured
        graph.replay()
        self.replays += 1
        for k in launches:
            k.launches += 1


def graph_phases(ctx, enabled, freq) -> tuple:
    """The private-L2 engine's two graphs: phase 2, and phases 4-5."""
    def evict(m, p):
        home_evictions(ctx, m, enabled, p)

    def sharer_acks(m, p):
        sharer_step(ctx, m, ctx.cycle_ps(freq, enabled), enabled, p)
        home_acks_and_finish(ctx, m, enabled, p)

    return (evict, sharer_acks)


def _capture(ms, progress, fn) -> tuple:
    """(graph, the kernels its capture recorded, one entry a launch)."""
    from graphite_tpu_torch.ops import KERNELS

    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(ms.clone(), progress.clone())
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = {k: k.launches for k in KERNELS.values()}
    with torch.cuda.graph(graph):
        fn(ms, progress)
    launches = []
    for k, n in before.items():
        launches += [k] * (k.launches - n)
        k.launches = n           # recorded, not launched
    return graph, tuple(launches)


def memory_engine_step(ctx: MemCtx, ms: MemState, lanes, trace, core,
                       enabled, progress, mem_ok) -> None:
    """One engine iteration in place on `ms`: adds the protocol events to
    `progress` and writes `mem_ok` (every slot of each lane's record
    complete).  Reads the pre-commit core clock and frequency.

    On the card every phase runs (the kernels and the masked plain
    phases gate themselves, with no host read; the plain phases as the
    CUDA graphs of `ctx.phase_graphs`).  On the CPU, where a host read
    costs nothing, the whole-engine gate and the six phase predicates
    are evaluated exactly as the JAX step does and a phase whose
    predicate is false is skipped — the same result, in a fraction of
    the time."""
    if core.idx.device.type != "cpu":
        graphs = ctx.phase_graphs
        evict, sharer_acks = graphs.get(ctx, ms, enabled, core.freq_mhz,
                                        progress)
        mem_requester(ctx, ms, lanes, trace, core, enabled, progress)
        graphs.replay(evict)
        mem_home_start(ctx, ms, enabled, progress)
        graphs.replay(sharer_acks)
        mem_requester_fill(ctx, ms, lanes, trace, core, enabled, progress,
                           mem_ok)
        return
    rec = MemRec.fetch(lanes, trace, core.idx)
    present = slots_present(ctx.mp, rec.op, rec.flags, enabled)
    req, mail, txn = ms.req, ms.mail, ms.txn
    idle = req.phase == PHASE_IDLE
    pending_slot = next_present_slot(present, req.slot) < 3
    if not bool(protocol_live(ms)
                | (lanes.active & present.any(dim=1)).any()):
        mem_ok.copy_(idle & ~pending_slot)
        return
    if bool((lanes.active & idle & pending_slot).any()):
        mem_requester(ctx, ms, lanes, trace, core, enabled, progress,
                      rec=rec)
    if bool((mail.evict_type != MSG_NONE).any()):
        home_evictions(ctx, ms, enabled, progress)
    if bool((mail.req_type != MSG_NONE).any()
            | (txn.saved_valid & ~txn.active).any()):
        mem_home_start(ctx, ms, enabled, progress)
    if bool((mail.fwd_type != MSG_NONE).any()):
        sharer_step(ctx, ms, ctx.cycle_ps(core.freq_mhz, enabled), enabled,
                    progress)
    if bool((mail.ack_type != MSG_NONE).any() | txn.active.any()):
        home_acks_and_finish(ctx, ms, enabled, progress)
    if bool(((req.phase == PHASE_WAIT_REPLY)
             & (mail.rep_type != MSG_NONE)).any()):
        mem_requester_fill(ctx, ms, lanes, trace, core, enabled, progress,
                           mem_ok, rec=rec)
    else:
        mem_ok.copy_((req.phase == PHASE_IDLE)
                     & (next_present_slot(present, req.slot) >= 3))


# ---------------------------------------------------------------------------
# host-side census


def line_census(ms: MemState, mp, lines) -> dict:
    """Per-line coherence view of a MemState (`engine.py:2713`): per
    line, the L1-D and L2 state on every tile, the directory entry
    (dstate, owner, frozenset of sharers) or None, and whether the home's
    flushed-data buffer holds it."""
    l1d = ms.l1d.meta.cpu().numpy()
    l2 = ms.l2.meta.cpu().numpy()
    entry = ms.directory.entry.cpu().numpy()
    sharers = ms.directory.sharers.cpu().numpy()
    cdata_line = ms.txn.cdata_line.cpu().numpy()
    cdata_valid = ms.txn.cdata_valid.cpu().numpy()
    T = mp.n_tiles
    sw = mp.sharer_words

    def cache_state(meta, line):
        tag = (meta >> 16).astype("int32")
        st = (meta >> 8) & 0xFF
        out = []
        for t in range(T):
            s = line % meta.shape[1]
            hit = tag[t, s, :] == line
            out.append(int(st[t, s, hit.argmax()]) if hit.any() else 0)
        return tuple(out)

    out = {}
    for line in lines:
        home = mp.mc_tiles[line % len(mp.mc_tiles)]
        dset = line % mp.dir_sets
        dent = None
        for w in range(mp.dir_ways):
            word = int(entry[home, dset, w])
            if (word & ((1 << DIR_TAG_BITS) - 1)) - 1 != line:
                continue
            dstate = (word >> DIR_STATE_SHIFT) & 7
            owner = ((word >> DIR_OWNER_SHIFT)
                     & ((1 << DIR_ID_BITS) - 1)) - 1
            bits = sharers[home, dset, w * sw:(w + 1) * sw]
            shset = frozenset(
                i * 32 + b for i in range(sw) for b in range(32)
                if (int(bits[i]) >> b) & 1)
            dent = (int(dstate), int(owner), shset)
            break
        out[line] = {
            "l1d": cache_state(l1d, line),
            "l2": cache_state(l2, line),
            "dir": dent,
            "cdata": bool(cdata_valid[home]
                          and int(cdata_line[home]) == line),
        }
    return out
