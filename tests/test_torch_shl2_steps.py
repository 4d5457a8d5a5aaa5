"""The shared-L2 engine phase by phase: graphite_tpu_torch (CPU) against
graphite_tpu on the same states.

Hand-set states at T = 40 (two sharer words, the second one padded: 40
is not a multiple of 32), one a branch, each phase against the JAX
package's phase function (`_home_starts`, `_home_finish`,
`_requester_fill`, `_home_evictions`, `_sharer_step`): the NULLIFY of a
slice victim with L1 sharers and the saved request that follows, a
dirty victim with no L1 copy dropped to DRAM, a request to a line still
DATA_INVALID, the MESI EXCLUSIVE grant (also to a requester that is
already the line's only sharer), a second reader's WB downgrade of the
EXCLUSIVE owner, the ackwise broadcast row and an upgrader's own bit,
limited_no_broadcast's displacement and its MODIFIED entry at capacity,
the limitless trap, the acks of tiles 32-39 consumed, the reply adds
with tile 0 replied to in the same iteration as other tiles, the DRAM
arrival, a NULLIFY finishing dirty, a fill that waits on a busy
eviction cell, a MESI fill in EXCLUSIVE, an eviction notice and a FLUSH
served by a MODIFIED L1.  Every leaf of the state must equal the JAX
package's, and each case shows its branch.

Reached states: from the quantum boundaries of short 16-tile stress runs
under shared-L2 MSI and MESI, one whole engine iteration against the
JAX package's `shl2_engine_step` (the phase skips included).  One
`cuda`-marked test holds the three kernels to their plain versions on
chip_smoke.py's shared-L2 edge states (it skips without a card).
Tolerance: zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.memory import engine_shl2 as js2
from graphite_tpu.memory.engine import RecView
from graphite_tpu.memory.state import MOD_L1D, MOD_L2, MOD_NET_MEM
from graphite_tpu.time_types import cycles_to_ps
from graphite_tpu.trace import synthetic as j_syn

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.convert import mem_state_from_arrays
from graphite_tpu_torch.convert import trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.memory import cache_array as ca
from graphite_tpu_torch.memory import engine_shl2 as te
from graphite_tpu_torch.memory.context import MemRec
from graphite_tpu_torch.memory.state import (
    DATA_INVALID, DIR_EXCLUSIVE, DIR_MODIFIED, DIR_SHARED, DIR_UNCACHED,
    FAR, MSG_EX_REP, MSG_EX_REQ, MSG_EXCL_REP, MSG_FLUSH_REP,
    MSG_FLUSH_REQ, MSG_INV_REP, MSG_INV_REQ, MSG_NULLIFY, MSG_SH_REP,
    MSG_SH_REQ, MSG_WB_REQ, PHASE_WAIT_REPLY,
)
from graphite_tpu_torch.ops.shl2_home_start import shl2_home_start_plain
from graphite_tpu_torch.ops.shl2_requester_fill import (
    shl2_requester_fill_plain,
)

from test_torch_memory_steps import (
    _Core, assert_mem_equal, port_lanes, record_inputs, states, to_jax,
)


MSI = "pr_l1_sh_l2_msi"
MESI = "pr_l1_sh_l2_mesi"
# an odd L2 / DIRECTORY / MEMORY-net frequency (700 MHz) with a sync delay
ODD = """
[dvfs]
synchronization_delay = 2
domains = "<1.0, CORE, L1_ICACHE, L1_DCACHE, NETWORK_USER><0.7, L2_CACHE, DIRECTORY, NETWORK_MEMORY>"
"""
T = 40
HOME = 5
R = 7                      # the requester
STRIDE = T * 1024          # lines HOME + i * STRIDE share HOME's slice set


def line_at(i):
    return HOME + i * STRIDE


def case(protocol=MESI, scheme="full_map", k=2, trap=201):
    """(JAX simulator, port context, port ShL2State) at T = 40 tiles, the
    models on, nothing in flight."""
    text = (config_text(T, network="magic", shared_mem=True,
                        protocol=protocol, scheme=scheme, max_hw_sharers=k)
            + f"[limitless]\nsoftware_trap_penalty = {trap}\n" + ODD)
    batch = j_syn.memory_stress_trace(T, n_accesses=4, seed=1)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu")
    return js, ts.models.mem, ts.state.clone().mem


def put_line(ctx, ms, home, line, way, l2_state=ca.SHARED,
             dstate=DIR_UNCACHED, owner=-1, sharers=()):
    """The slice line `line` at `way` of its set on `home`, with its
    embedded directory entry."""
    s = line % ctx.mp.l2.num_sets
    lru = int(ms.l2.meta[home, s, way]) & 0xFF
    ms.l2.meta[home, s, way] = ca.pack(torch.tensor(line), l2_state, lru)
    ms.dir.word[home, s, way] = (dstate | ((owner + 1) << 3)
                                 | (len(sharers) << 16))
    SW = ctx.mp.sharer_words
    row = torch.zeros(SW, dtype=torch.int64)
    for t in sharers:
        row[t // 32] |= 1 << (t % 32)
    sh = ms.dir.sharers.view(T, -1, ctx.mp.l2.num_ways, SW)
    sh[home, s, way] = (row - ((row >> 31) << 32)).to(torch.int32)


def request(ms, r, rtype, line, home=HOME, time=3_000_000):
    ms.mail.req_type[r] = rtype
    ms.mail.req_home[r] = home
    ms.mail.req_line[r] = line
    ms.mail.req_time[r] = time


def entry(ctx, ms, line, home=HOME):
    """(slice state, dstate, owner, nsharers, sharer set) of `line`."""
    s = line % ctx.mp.l2.num_sets
    meta = ms.l2.meta[home, s]
    hit = torch.nonzero((meta >> 16) == line)
    if len(hit) == 0:
        return None
    way = int(hit[0, 0])
    w = int(ms.dir.word[home, s, way])
    SW = ctx.mp.sharer_words
    bits = ms.dir.sharers.view(T, -1, ctx.mp.l2.num_ways, SW)[home, s, way]
    shset = {i * 32 + b for i in range(SW) for b in range(32)
             if (int(bits[i]) >> b) & 1}
    return ((int(meta[way]) >> 8) & 0xFF, w & 7, ((w >> 3) & 8191) - 1,
            (w >> 16) & 8191, shset)


def fwd_column(ms, home=HOME):
    col = ms.mail.fwd_type[:, home]
    return {int(s): int(col[s]) for s in torch.nonzero(col)[:, 0]}


def pending(ms, home=HOME):
    bits = ms.txn.pending[home]
    return {w * 32 + b for w in range(bits.shape[0]) for b in range(32)
            if (int(bits[w]) >> b) & 1}


def run_phase(phase, js, ctx, ms):
    """One phase on the state, both packages, held equal leaf for leaf;
    returns the port's state and the phase's progress."""
    mp = js.params.mem
    i64 = jnp.int64
    en = jnp.asarray(True)
    fmhz = jnp.asarray(js.state.core.freq_mhz).astype(i64)

    def ccyc(n):
        return jnp.where(en, cycles_to_ps(jnp.asarray(n, i64), fmhz), 0)

    l2_access = ccyc(mp.l2.data_and_tags_cycles)
    sync_l2_net = ccyc(mp.sync_cycles(MOD_L2, MOD_NET_MEM))
    sync_l1_net = ccyc(mp.sync_cycles(MOD_L1D, MOD_NET_MEM))
    zero = jnp.zeros((), jnp.int32)
    mesi = mp.protocol.endswith("mesi")
    jms = to_jax(ms, js.state.mem)
    ten = torch.tensor(True)
    tf = torch.from_numpy(np.array(js.state.core.freq_mhz)).to(
        torch.int64)
    cps = ctx.cycle_ps(tf, ten)
    tprog = torch.zeros(1, dtype=torch.int32)
    if phase == "home_start":
        jms, jp = js2._home_starts(mp, jms, l2_access, sync_l2_net, en, zero,
                                   mesi)
        shl2_home_start_plain(ctx, ms, cps, ten, tprog)
    elif phase == "home_finish":
        jms, jp = js2._home_finish(mp, jms, l2_access, sync_l2_net, en, zero,
                                   mesi)
        te.home_finish(ctx, ms, cps, ten, tprog)
    elif phase == "home_evict":
        jms, jp = js2._home_evictions(mp, jms, l2_access, en, zero)
        te.home_evictions(ctx, ms, cps, ten, tprog)
    elif phase == "sharer":
        jms, jp = js2._sharer_step(mp, jms, fmhz, en, zero, sync_l1_net)
        te.sharer_step(ctx, ms, tf, ten, tprog)
    else:
        st = js.state
        rec = record_inputs(js, st)
        jrec = RecView(**{n: jnp.asarray(rec[n]) for n in (
            "op", "flags", "pc", "addr0", "addr1", "aux0", "aux1")})
        clock = jnp.asarray(st.core.clock_ps)
        jms, jp = js2._requester_fill(mp, jms, jrec, clock, fmhz, en, zero,
                                      sync_l1_net)
        core = _Core(st)
        lanes = port_lanes(rec, T)
        trec = MemRec.fetch(lanes, _trace(js), core.idx)
        shl2_requester_fill_plain(ctx, ms, trec, core.clock_ps, tf, ten,
                                  tprog, torch.zeros(T, dtype=torch.bool))
    assert_mem_equal(jax.device_get(jms), ms, phase)
    assert int(jp) == int(tprog)
    return ms, int(tprog)


def _trace(js):
    tr = js.trace_batch

    class _T:
        addr0 = torch.from_numpy(np.asarray(tr.addr0).astype(np.int64))
        addr1 = torch.from_numpy(np.asarray(tr.addr1).astype(np.int64))
    return _T


# --- phase 5, the home starts ----------------------------------------------

def test_nullify_then_saved_request():
    """A full slice set whose LRU victim has L1 sharers: the request is
    saved and a NULLIFY sweep invalidates the victim's sharers (the
    saved requester's copy too); once that transaction is over, the
    saved request resumes and installs its line in DATA_INVALID."""
    js, ctx, ms = case(MSI)
    for w in range(8):
        put_line(ctx, ms, HOME, line_at(w + 1), w,
                 dstate=DIR_SHARED if w == 7 else DIR_UNCACHED,
                 sharers=(3, R, 35) if w == 7 else ())
    request(ms, R, MSG_SH_REQ, line_at(20))
    ms, prog = run_phase("home_start", js, ctx, ms)
    assert prog == 1
    assert int(ms.txn.mtype[HOME]) == MSG_NULLIFY
    assert int(ms.txn.line[HOME]) == line_at(8)
    assert pending(ms) == {3, R, 35}
    assert fwd_column(ms) == {3: MSG_INV_REQ, R: MSG_INV_REQ,
                              35: MSG_INV_REQ}
    assert bool(ms.txn.saved_valid[HOME])
    assert int(ms.mail.req_type[R]) == 0
    # the NULLIFY over: the saved request resumes
    ms.txn.active[HOME] = False
    ms.txn.pending[HOME] = 0
    ms.mail.fwd_type.zero_()
    put_line(ctx, ms, HOME, line_at(8), 7, l2_state=ca.INVALID)
    ms, prog = run_phase("home_start", js, ctx, ms)
    assert prog == 1 and not bool(ms.txn.saved_valid[HOME])
    assert entry(ctx, ms, line_at(20))[:2] == (DATA_INVALID, DIR_UNCACHED)
    assert int(ms.txn.dram_ready_ps[HOME]) < FAR
    assert int(ms.counters.l2_misses[HOME]) == 1


def test_dirty_victim_without_copies_dropped_to_dram():
    js, ctx, ms = case(MSI)
    for w in range(8):
        put_line(ctx, ms, HOME, line_at(w + 1), w,
                 l2_state=ca.MODIFIED if w == 7 else ca.SHARED)
    request(ms, R, MSG_EX_REQ, line_at(20))
    ms, _ = run_phase("home_start", js, ctx, ms)
    assert int(ms.counters.dram_writes[HOME]) == 1
    assert entry(ctx, ms, line_at(8)) is None
    assert entry(ctx, ms, line_at(20))[0] == DATA_INVALID


def test_request_to_line_still_data_invalid():
    js, ctx, ms = case(MSI)
    put_line(ctx, ms, HOME, line_at(1), 0, l2_state=DATA_INVALID)
    request(ms, R, MSG_SH_REQ, line_at(1))
    ms, _ = run_phase("home_start", js, ctx, ms)
    assert int(ms.counters.l2_misses[HOME]) == 1
    assert int(ms.counters.l2_hits[HOME]) == 0
    assert int(ms.txn.dram_ready_ps[HOME]) < FAR and fwd_column(ms) == {}


@pytest.mark.parametrize("name", ["wb_downgrade_exclusive", "ackwise_row",
                                  "ackwise_upgrade", "lnb_displacement",
                                  "lnb_exclusive_at_capacity",
                                  "limitless_trap"])
def test_home_start_branch(name):
    protocol, scheme, k = {
        "wb_downgrade_exclusive": (MESI, "full_map", 2),
        "ackwise_row": (MSI, "ackwise", 2),
        "ackwise_upgrade": (MESI, "ackwise", 2),
        "lnb_displacement": (MESI, "limited_no_broadcast", 2),
        "lnb_exclusive_at_capacity": (MESI, "limited_no_broadcast", 1),
        "limitless_trap": (MSI, "limitless", 2),
    }[name]
    js, ctx, ms = case(protocol, scheme, k)
    ln = line_at(1)
    if name in ("wb_downgrade_exclusive", "lnb_exclusive_at_capacity"):
        put_line(ctx, ms, HOME, ln, 0, dstate=DIR_EXCLUSIVE, owner=3,
                 sharers=(3,))
        request(ms, R, MSG_SH_REQ, ln)
    else:
        holders = (3, R, 35) if name == "ackwise_upgrade" else (3, 9, 35)
        put_line(ctx, ms, HOME, ln, 0, dstate=DIR_SHARED, sharers=holders)
        request(ms, R, MSG_SH_REQ if name.startswith(("lnb", "limitless"))
                else MSG_EX_REQ, ln)
    if name == "limitless_trap":
        base = case(protocol, scheme, 64)
        put_line(base[1], base[2], HOME, ln, 0, dstate=DIR_SHARED,
                 sharers=(3, 9, 35))
        request(base[2], R, MSG_SH_REQ, ln)
        ref = run_phase("home_start", *base)[0]
    ms, _ = run_phase("home_start", js, ctx, ms)
    fwd, pend = fwd_column(ms), pending(ms)
    if name == "wb_downgrade_exclusive":
        assert (fwd, pend) == ({3: MSG_WB_REQ}, {3})
    elif name.startswith("ackwise"):
        # every tile but the requester gets a copy; the acks awaited are
        # the holders' (an upgrader's own bit cleared)
        assert set(fwd) == set(range(T)) - {R}
        assert pend == ({3, 35} if name == "ackwise_upgrade" else {3, 9, 35})
        assert int(ms.counters.dir_broadcasts[HOME]) == 1
    elif name == "lnb_displacement":
        assert (fwd, pend) == ({3: MSG_INV_REQ}, {3})
        assert entry(ctx, ms, ln)[3:] == (2, {9, 35})
    elif name == "lnb_exclusive_at_capacity":
        assert (fwd, pend) == ({3: MSG_FLUSH_REQ}, {3})
        assert entry(ctx, ms, ln)[1:] == (DIR_UNCACHED, -1, 0, set())
    else:
        trap = int(ms.txn.time_ps[HOME]) - int(ref.txn.time_ps[HOME])
        assert trap == -(-201 * 10**6 // 700)


# --- phase 4, the home finishes --------------------------------------------

def active_txn(ms, home, mtype, line, requester, pend=(), time=4_000_000):
    ms.txn.active[home] = True
    ms.txn.mtype[home] = mtype
    ms.txn.line[home] = line
    ms.txn.requester[home] = requester
    ms.txn.req_comp[home] = MOD_L1D
    ms.txn.time_ps[home] = time
    ms.txn.dram_ready_ps[home] = FAR
    words = torch.zeros(ms.txn.pending.shape[1], dtype=torch.int64)
    for t in pend:
        words[t // 32] |= 1 << (t % 32)
    ms.txn.pending[home] = (words - ((words >> 31) << 32)).to(torch.int32)


def test_reply_adds_with_tile_zero_replied_to():
    """Tile 0 and tile 9 get replies in one iteration while the other
    homes reply to nobody: each of those adds 0 into cell 0 (the JAX
    scatter-add), which must leave tile 0's reply intact."""
    js, ctx, ms = case(MESI)
    put_line(ctx, ms, HOME, line_at(1), 0)
    put_line(ctx, ms, 11, 11 + 2 * STRIDE, 0, dstate=DIR_SHARED,
             sharers=(4,))
    active_txn(ms, HOME, MSG_EX_REQ, line_at(1), 0)
    active_txn(ms, 11, MSG_SH_REQ, 11 + 2 * STRIDE, 9)
    ms, prog = run_phase("home_finish", js, ctx, ms)
    assert prog == 2
    assert int(ms.mail.rep_type[0]) == MSG_EX_REP
    assert int(ms.mail.rep_type[9]) == MSG_SH_REP
    assert int(ms.mail.rep_time[0]) > 4_000_000


def test_acks_of_the_padded_word_consumed():
    """Acks from tiles 33-39 (the second sharer word, 24 bits of padding)
    clear their pending bits; the FLUSH data turns the slice MODIFIED and
    the EX finishes."""
    js, ctx, ms = case(MSI)
    put_line(ctx, ms, HOME, line_at(1), 0, dstate=DIR_SHARED,
             sharers=(33, 36, 39))
    active_txn(ms, HOME, MSG_EX_REQ, line_at(1), R, pend=(33, 36, 39))
    for t, msg in ((33, MSG_INV_REP), (36, MSG_FLUSH_REP),
                   (39, MSG_INV_REP)):
        ms.mail.ack_type[HOME, t] = msg
        ms.mail.ack_line[HOME, t] = line_at(1)
        ms.mail.ack_time[HOME, t] = 5_000_000 + t
    ms, _ = run_phase("home_finish", js, ctx, ms)
    assert pending(ms) == set() and not bool(ms.txn.active[HOME])
    assert entry(ctx, ms, line_at(1)) == (ca.MODIFIED, DIR_MODIFIED, R, 1,
                                          {R})
    assert int(ms.mail.rep_type[R]) == MSG_EX_REP


@pytest.mark.parametrize("had", [False, True])
def test_mesi_exclusive_grant(had):
    """A lone reader is granted EXCLUSIVE, also when it is already the
    line's only tracked sharer (nsharers - had == 0)."""
    js, ctx, ms = case(MESI)
    put_line(ctx, ms, HOME, line_at(1), 0,
             dstate=DIR_SHARED if had else DIR_UNCACHED,
             sharers=(R,) if had else ())
    active_txn(ms, HOME, MSG_SH_REQ, line_at(1), R)
    ms, _ = run_phase("home_finish", js, ctx, ms)
    assert int(ms.mail.rep_type[R]) == MSG_EXCL_REP
    assert entry(ctx, ms, line_at(1))[1:] == (DIR_EXCLUSIVE, R, 1, {R})


def test_dram_arrival_and_dirty_nullify():
    """Home 5's fetch arrives (the line turns SHARED, the reply waits for
    it); home 6's NULLIFY finishes with flushed data (a DRAM write, the
    slice line and the entry gone)."""
    js, ctx, ms = case(MSI)
    put_line(ctx, ms, HOME, line_at(1), 0, l2_state=DATA_INVALID)
    active_txn(ms, HOME, MSG_SH_REQ, line_at(1), R)
    ms.txn.dram_ready_ps[HOME] = 9_000_000
    other = 6 + 3 * STRIDE
    put_line(ctx, ms, 6, other, 0, dstate=DIR_SHARED, sharers=(2,))
    active_txn(ms, 6, MSG_NULLIFY, other, 2)
    ms.txn.got_flush[6] = True
    ms, _ = run_phase("home_finish", js, ctx, ms)
    assert entry(ctx, ms, line_at(1))[0] == ca.SHARED
    assert int(ms.mail.rep_time[R]) > 9_000_000
    assert int(ms.counters.dram_writes[6]) == 1
    assert entry(ctx, ms, other, home=6)[0] == ca.INVALID


# --- phases 6, 3 and 2 -----------------------------------------------------

def _l1_fill_state(ms, ctx, t, lines, state=ca.SHARED):
    """Tile t's L1-D set of lines[0] full of `lines`."""
    s = lines[0] % ctx.mp.l1d.num_sets
    for w, ln in enumerate(lines):
        lru = int(ms.l1d.meta[t, s, w]) & 0xFF
        ms.l1d.meta[t, s, w] = ca.pack(torch.tensor(ln), state, lru)


def test_fill_waits_on_busy_eviction_cell_and_excl_fill():
    """Tile R's reply would evict a line whose home cell for R is still
    busy: no fill this iteration; tile 3's EXCL_REP fills EXCLUSIVE and
    evicts its MODIFIED victim with a FLUSH."""
    js, ctx, ms = case(MESI)
    S1 = ctx.mp.l1d.num_sets
    W1 = ctx.mp.l1d.num_ways
    for t, rt in ((R, MSG_SH_REP), (3, MSG_EXCL_REP)):
        lines = [t + 1 + i * S1 * T for i in range(W1 + 1)]
        _l1_fill_state(ms, ctx, t, lines[:W1],
                       ca.MODIFIED if t == 3 else ca.SHARED)
        ms.req.phase[t] = PHASE_WAIT_REPLY
        ms.req.line[t] = lines[W1]
        ms.req.component[t] = 2
        ms.mail.rep_type[t] = rt
        ms.mail.rep_time[t] = 6_000_000
    v_home_r = (R + 1 + (W1 - 1) * S1 * T) % T
    ms.mail.evict_type[v_home_r, R] = MSG_INV_REP
    ms, prog = run_phase("fill", js, ctx, ms)
    assert prog == 1
    assert int(ms.req.phase[R]) == PHASE_WAIT_REPLY
    assert int(ms.req.phase[3]) == 0
    s3 = ms.req.line[3] % S1
    states3 = {int(m) >> 16: (int(m) >> 8) & 0xFF
               for m in ms.l1d.meta[3, s3]}
    assert states3[int(ms.req.line[3])] == ca.EXCLUSIVE
    assert MSG_FLUSH_REP in ms.mail.evict_type[:, 3].tolist()


def test_eviction_notice_and_flush_service():
    """Home 5 takes tile 3's FLUSH notice (the sharer leaves, the slice
    turns MODIFIED, the owner is cleared); tile 9 serves a FLUSH of its
    MODIFIED copy (a FLUSH_REP carrying data)."""
    js, ctx, ms = case(MSI)
    put_line(ctx, ms, HOME, line_at(1), 0, dstate=DIR_MODIFIED, owner=3,
             sharers=(3,))
    ms.mail.evict_type[HOME, 3] = MSG_FLUSH_REP
    ms.mail.evict_line[HOME, 3] = line_at(1)
    ms.mail.evict_time[HOME, 3] = 2_000_000
    ms, _ = run_phase("home_evict", js, ctx, ms)
    assert entry(ctx, ms, line_at(1)) == (ca.MODIFIED, DIR_UNCACHED, -1, 0,
                                          set())
    ln = line_at(2)
    _l1_fill_state(ms, ctx, 9, [ln], ca.MODIFIED)
    ms.mail.fwd_type[9, HOME] = MSG_FLUSH_REQ
    ms.mail.fwd_line[9, HOME] = ln
    ms.mail.fwd_time[9, HOME] = 2_500_000
    ms, _ = run_phase("sharer", js, ctx, ms)
    assert int(ms.mail.ack_type[HOME, 9]) == MSG_FLUSH_REP


# --- reached states ----------------------------------------------------------

@pytest.mark.parametrize("protocol", [MSI, MESI])
def test_engine_iteration_equal_on_reached_states(protocol):
    """From each quantum boundary of a 16-tile stress run: one whole
    engine iteration, the port's `shl2_engine_step` against the JAX
    package's (every phase predicate and skip count included)."""
    js, ts, sts = states(f"[caching_protocol]\ntype = {protocol}\n",
                         n_states=6)
    mp = js.params.mem
    ctx = ts.models.mem
    step = jax.jit(lambda ms, rec, *a: js2.shl2_engine_step(
        mp, ms, RecView(**rec), *a))
    events = 0
    for n, st in enumerate(sts):
        rec = record_inputs(js, st)
        jrec = {k: jnp.asarray(rec[k]) for k in (
            "op", "flags", "pc", "addr0", "addr1", "aux0", "aux1")}
        en = jnp.asarray(st.models_enabled)
        out = step(
            jax.tree_util.tree_map(jnp.asarray, st.mem), jrec,
            jnp.asarray(st.core.clock_ps), jnp.asarray(st.core.freq_mhz),
            jnp.asarray(rec["active"]), en)
        tms = mem_state_from_arrays(st.mem, "cpu")
        lanes = port_lanes(rec, 16)
        prog = torch.zeros(1, dtype=torch.int32)
        ok = torch.zeros(16, dtype=torch.bool)
        te.shl2_engine_step(ctx, tms, lanes, ts.device_trace, _Core(st),
                            torch.tensor(bool(st.models_enabled)), prog, ok)
        assert_mem_equal(jax.device_get(out.ms), tms, f"state {n}")
        assert int(out.progress) == int(prog[0]), n
        np.testing.assert_array_equal(np.asarray(out.mem_complete),
                                      ok.numpy())
        events += int(prog[0])
    assert events > 0


@pytest.mark.cuda
def test_shl2_kernels_equal_plain_versions_on_card():
    """On a CUDA host: chip_smoke.py's shared-L2 edge states, each kernel
    against its plain version (max abs err 0), each state's branch
    shown."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    stats = chip_smoke.new_stats()
    chip_smoke.shl2_edge_cases("cuda", stats)
    for name in ("shl2_requester", "shl2_home_start", "shl2_requester_fill"):
        assert stats[name]["checks"] > 0, name
        assert stats[name]["max_abs_err"] == 0, name
