"""MOSI and the directory schemes phase by phase: graphite_tpu_torch (CPU)
against graphite_tpu on the same states.

Hand-set states of phase 3 (`_home_starts` against the port's
`mem_home_start_plain`), one a branch the slice adds: MOSI's
cache-to-cache SH fetch from an OWNED entry's owner and from the lowest
sharer, the INV_FLUSH_COMBINED supplier of an EX on SHARED and on OWNED;
limited_no_broadcast's displacement under MSI and under MOSI (a SHARED
and an OWNED entry), the owner as the only victim, the MODIFIED entry
at capacity; the ackwise and limited_broadcast sweep to every tile; the
limitless trap at an odd directory frequency.  Each state's result must
equal the JAX package's, leaf for leaf, and show its branch (the FWD
cells, the pending acks, the directory entry, `dir_broadcasts`, the
reply time).

Reached states: the quantum boundaries of short 16-tile stress runs
under MOSI with each scheme (tests/test_torch_memory_steps.py's
harness), phases 2-5 in the engine's order against the JAX package's
module-level phase functions; phases 3-5 must differ somewhere from the
same phase run as MSI full_map on the same state (the new branches
fired), and phase 2 must not (it is protocol-independent).
Tolerance: zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.memory import engine as je
from graphite_tpu.memory.state import MOD_DIR, MOD_L1D, MOD_L2, MOD_NET_MEM
from graphite_tpu.time_types import cycles_to_ps
from graphite_tpu.trace import synthetic as j_syn

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.convert import mem_state_from_arrays
from graphite_tpu_torch.convert import trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.memory import engine as te
from graphite_tpu_torch.memory.common import pack_bits
from graphite_tpu_torch.memory.context import MemCtx
from graphite_tpu_torch.memory.state import (
    DIR_MODIFIED, DIR_OWNED, DIR_SHARED, DIR_UNCACHED, MSG_EX_REQ,
    MSG_FLUSH_REQ, MSG_INV_REQ, MSG_SH_REQ, MSG_WB_REQ,
)
from graphite_tpu_torch.ops.mem_home_start import (
    dir_view, dir_write, mem_home_start_plain,
)

from test_torch_memory_steps import assert_mem_equal, states, to_jax

MSI = "pr_l1_pr_l2_dram_directory_msi"
MOSI = "pr_l1_pr_l2_dram_directory_mosi"
# an odd DIRECTORY frequency (700 MHz): the trap's ceil-division shows
ODD_DIR = """
[dvfs]
synchronization_delay = 2
domains = "<1.0, CORE, L1_ICACHE, L1_DCACHE, NETWORK_USER><0.7, L2_CACHE, DIRECTORY, NETWORK_MEMORY>"
"""
T = 16
HOME = 5
R = 7                     # the requester


def case_text(protocol, scheme, k, trap=201, extra=""):
    return (config_text(T, shared_mem=True, protocol=protocol, scheme=scheme,
                        max_hw_sharers=k)
            + f"[limitless]\nsoftware_trap_penalty = {trap}\n" + extra)


# name -> (protocol, scheme, k, entry state, owner, sharers, request)
HOME_CASES = {
    "sh_fetch_owner": (MOSI, "full_map", 2, DIR_OWNED, 2, (2, 9),
                       MSG_SH_REQ),
    "sh_fetch_lowest_sharer": (MOSI, "full_map", 2, DIR_SHARED, -1,
                               (3, 9, 12), MSG_SH_REQ),
    "flush_pick_shared": (MOSI, "full_map", 2, DIR_SHARED, -1, (3, 9, 12),
                          MSG_EX_REQ),
    "flush_pick_owned": (MOSI, "full_map", 2, DIR_OWNED, 9, (3, 9),
                         MSG_EX_REQ),
    "sh_over_msi": (MSI, "limited_no_broadcast", 2, DIR_SHARED, -1, (3, 9),
                    MSG_SH_REQ),
    "sh_over_mosi_shared": (MOSI, "limited_no_broadcast", 2, DIR_SHARED, -1,
                            (3, 9), MSG_SH_REQ),
    "sh_over_mosi_owned": (MOSI, "limited_no_broadcast", 2, DIR_OWNED, 3,
                           (3, 9), MSG_SH_REQ),
    "victim_is_owner": (MOSI, "limited_no_broadcast", 1, DIR_OWNED, 3, (3,),
                        MSG_SH_REQ),
    "sh_over_m": (MSI, "limited_no_broadcast", 1, DIR_MODIFIED, 3, (3,),
                  MSG_SH_REQ),
    "over_bc_ackwise": (MOSI, "ackwise", 2, DIR_SHARED, -1, (3, 9, 12),
                        MSG_EX_REQ),
    "over_bc_limited_broadcast": (MSI, "limited_broadcast", 2, DIR_SHARED,
                                  -1, (3, 9, 12), MSG_EX_REQ),
    "limitless_trap": (MSI, "limitless", 2, DIR_SHARED, -1, (3, 9, 12),
                       MSG_SH_REQ),
}


def home_case(name, k=None):
    """(JAX simulator, port context, port MemState) of the hand-set state
    `name`: home HOME holds the line (HOME + 16 * 40) in the given entry
    state, and requester R has its request for it pending."""
    protocol, scheme, k0, dstate, owner, sharers, rtype = HOME_CASES[name]
    text = case_text(protocol, scheme, k0 if k is None else k, extra=ODD_DIR)
    batch = j_syn.memory_stress_trace(T, n_accesses=4, seed=1)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu")
    ctx = MemCtx(ts.params.mem, "cpu")
    ms = ts.state.clone().mem
    line = HOME + T * 40
    assert int(ctx.home_of(torch.tensor([line]))[0]) == HOME
    ms.mail.req_type[R] = rtype
    ms.mail.req_home[R] = HOME
    ms.mail.req_line[R] = line
    ms.mail.req_time[R] = 3_000_000
    rows = torch.arange(T)
    share = torch.zeros((T, T), dtype=torch.bool)
    share[HOME, list(sharers)] = True
    mask = rows == HOME
    full = torch.full((T,), line, dtype=torch.int64)
    dir_write(ms, rows, full % ctx.mp.dir_sets, torch.zeros_like(rows), mask,
              tags=full, dstate=torch.full((T,), dstate),
              owner=torch.full((T,), owner),
              sharers=pack_bits(share, ctx.mp.sharer_words),
              nsharers=share.sum(dim=1).to(torch.int32))
    return js, ctx, ms


def run_home_starts(js, ctx, ms):
    """Phase 3 on the state, both packages; returns the port's state."""
    mp = js.params.mem
    en = jnp.asarray(True)
    i64 = jnp.int64

    def dps(n):
        return cycles_to_ps(jnp.asarray(n, i64), mp.dir_freq_mhz)

    dram = jnp.asarray((mp.dram_latency_ns + mp.dram_processing_ns) * 1000,
                       i64)
    jms = to_jax(ms, js.state.mem)
    jms, jp = je._home_starts(
        mp, jms, dram, dps(mp.dir_access_cycles),
        dps(mp.sync_cycles(MOD_DIR, MOD_L2)),
        dps(mp.sync_cycles(MOD_DIR, MOD_NET_MEM)), en,
        jnp.zeros((), jnp.int32))
    tprog = torch.zeros(1, dtype=torch.int32)
    mem_home_start_plain(ctx, ms, torch.tensor(True), tprog)
    assert_mem_equal(jax.device_get(jms), ms, "phase 3")
    assert int(jp) == int(tprog) == 1
    return ms


def fwd_column(ms):
    """{target: message} of the home's FWD column."""
    col = ms.mail.fwd_type[:, HOME]
    return {int(s): int(col[s]) for s in torch.nonzero(col)[:, 0]}


def pending(ms):
    bits = ms.txn.pending[HOME]
    return {w * 32 + b for w in range(bits.shape[0]) for b in range(32)
            if (int(bits[w]) >> b) & 1}


def entry(ms, ctx):
    line = torch.full((T,), HOME + T * 40, dtype=torch.int32)
    _, words, sh, dfound, way = dir_view(ms, line, torch.arange(T))
    w = int(words[HOME, way[HOME]])
    bits = sh[HOME, way[HOME]]
    shset = {i * 32 + b for i in range(bits.shape[0]) for b in range(32)
             if (int(bits[i]) >> b) & 1}
    return ((w >> 34) & 7, ((w >> 37) & 8191) - 1, (w >> 50) & 8191, shset)


@pytest.mark.parametrize("name", sorted(HOME_CASES))
def test_home_start_branch_equal(name):
    js, ctx, ms = home_case(name)
    ms = run_home_starts(js, ctx, ms)
    fwd, pend = fwd_column(ms), pending(ms)
    INV, FL, WB = MSG_INV_REQ, MSG_FLUSH_REQ, MSG_WB_REQ
    expect = {
        "sh_fetch_owner": ({2: WB}, {2}),
        "sh_fetch_lowest_sharer": ({3: WB}, {3}),
        "flush_pick_shared": ({3: FL, 9: INV, 12: INV}, {3, 9, 12}),
        "flush_pick_owned": ({3: INV, 9: FL}, {3, 9}),
        "sh_over_msi": ({3: INV}, {3}),
        "sh_over_mosi_shared": ({3: FL}, {3}),
        "sh_over_mosi_owned": ({3: WB, 9: INV}, {3, 9}),
        "victim_is_owner": ({3: FL}, {3}),
        "sh_over_m": ({3: FL}, {3}),
    }
    if name in expect:
        assert (fwd, pend) == expect[name]
        assert bool(ms.txn.active[HOME])
    dstate, owner, nsh, shset = entry(ms, ctx)
    if name == "sh_over_mosi_owned":
        assert (dstate, owner, nsh, shset) == (DIR_OWNED, 3, 1, {3})
    elif name == "victim_is_owner":
        assert (dstate, owner, nsh, shset) == (DIR_SHARED, -1, 0, set())
    elif name == "sh_over_m":
        assert (dstate, owner, nsh, shset) == (DIR_UNCACHED, -1, 0, set())
    elif name in ("sh_over_msi", "sh_over_mosi_shared"):
        assert (nsh, shset) == (1, {9})
    elif name.startswith("over_bc"):
        # every tile gets a copy; the acks awaited stay the holders
        assert len(fwd) == T and pend == {3, 9, 12}
        assert int(ms.counters.dir_broadcasts[HOME]) == 1
        assert fwd[3] == (FL if name == "over_bc_ackwise" else INV)
    elif name == "limitless_trap":
        # an immediate SH finish, the trap at 700 MHz on its reply
        ms64 = run_home_starts(*home_case(name, k=64))
        trap = int(ms.mail.rep_time[R]) - int(ms64.mail.rep_time[R])
        assert trap == -(-201 * 10**6 // 700) == 287143
        assert not bool(ms.txn.active[HOME])


@pytest.mark.parametrize("scheme,k", [("full_map", 2),
                                      ("limited_no_broadcast", 1),
                                      ("ackwise", 2), ("limitless", 2)])
def test_phases_equal_mosi(scheme, k):
    """Reached states: phases 2-5 in the engine's order, port against JAX,
    from each quantum boundary of a 16-tile MOSI stress run (the port's
    phase 1 handed to the JAX package first); each phase also run as MSI
    full_map on a copy of the same state."""
    from test_torch_memory_steps import _Core, port_lanes, record_inputs
    from graphite_tpu_torch.memory.context import MemRec
    from graphite_tpu_torch.ops.mem_requester import mem_requester_plain

    extra = (f"[caching_protocol]\ntype = {MOSI}\n[dram_directory]\n"
             f"directory_type = {scheme}\nmax_hw_sharers = {k}\n"
             "[limitless]\nsoftware_trap_penalty = 201\n" + ODD_DIR)
    js, ts, sts = states(extra, n_states=8)
    mp = js.params.mem
    ctx = MemCtx(ts.params.mem, "cpu")
    msi = MemCtx(dataclasses.replace(ts.params.mem, protocol=MSI,
                                     dir_type="full_map"), "cpu")
    differ = {p: 0 for p in ("evict", "start", "sharer", "finish")}
    events = 0
    for n, st in enumerate(sts):
        en = jnp.asarray(st.models_enabled)
        fmhz = jnp.asarray(st.core.freq_mhz).astype(jnp.int64)
        i64 = jnp.int64

        def dps(c):
            return jnp.where(en, cycles_to_ps(jnp.asarray(c, i64),
                                              mp.dir_freq_mhz), 0)

        def cps(c):
            return jnp.where(en, cycles_to_ps(jnp.asarray(c, i64), fmhz), 0)

        dram = jnp.where(en, (mp.dram_latency_ns + mp.dram_processing_ns)
                         * 1000, 0).astype(i64)
        acc = dps(mp.dir_access_cycles)
        zero = jnp.zeros((), jnp.int32)
        rec = record_inputs(js, st)
        lanes = port_lanes(rec, T)
        core = _Core(st)
        tms = mem_state_from_arrays(st.mem, "cpu")
        ten = torch.tensor(bool(st.models_enabled))
        tf = core.freq_mhz.to(torch.int64)
        mem_requester_plain(ctx, tms, MemRec.fetch(lanes, ts.device_trace,
                                                   core.idx),
                            core.clock_ps, tf, lanes.active, ten,
                            torch.zeros(1, dtype=torch.int32))
        jms = to_jax(tms, jax.tree_util.tree_map(jnp.asarray, st.mem))
        phases = (
            ("evict", lambda m: je._home_evictions(mp, m, acc, en, zero),
             lambda c, m, p: te.home_evictions(c, m, ten, p)),
            ("start", lambda m: je._home_starts(
                mp, m, dram, acc, dps(mp.sync_cycles(MOD_DIR, MOD_L2)),
                dps(mp.sync_cycles(MOD_DIR, MOD_NET_MEM)), en, zero),
             lambda c, m, p: mem_home_start_plain(c, m, ten, p)),
            ("sharer", lambda m: je._sharer_step(
                mp, m, fmhz, en, zero, cps(mp.sync_cycles(MOD_L2,
                                                          MOD_NET_MEM)),
                cps(mp.sync_cycles(MOD_L1D, MOD_L2))),
             lambda c, m, p: te.sharer_step(c, m, c.cycle_ps(tf, ten), ten,
                                            p)),
            ("finish", lambda m: je._home_acks_and_finish(
                mp, m, dram, acc, en, zero),
             lambda c, m, p: te.home_acks_and_finish(c, m, ten, p)))
        for name, jfn, tfn in phases:
            other = tms.clone()
            tfn(msi, other, torch.zeros(1, dtype=torch.int32))
            jms, jp = jfn(jms)
            tprog = torch.zeros(1, dtype=torch.int32)
            tfn(ctx, tms, tprog)
            assert_mem_equal(jax.device_get(jms), tms, f"{name}, state {n}")
            assert int(jp) == int(tprog), f"{name}, state {n}"
            differ[name] += not _same(tms, other)
            events += int(jp)
    assert events > 0
    assert differ["evict"] == 0, "phase 2 depends on the protocol"
    assert differ["start"] > 0, "phase 3: no new branch fired"
    if k > 1:
        # (at k = 1 every read of a MODIFIED line flushes its owner out:
        # no WB downgrade, no OWNED finish)
        assert differ["sharer"] + differ["finish"] > 0, (
            "phases 4-5: no MOSI branch fired")


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_same(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a) if getattr(a, f.name)
               is not None)


@pytest.mark.cuda
def test_mosi_kernels_equal_plain_versions_on_card():
    """On a CUDA host: chip_smoke.py's MOSI edge states, each memory
    kernel against its plain version (max abs err 0), each state's
    branch shown."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    stats = chip_smoke.new_stats()
    chip_smoke.mosi_edge_cases("cuda", stats)
    for name in ("mem_requester", chip_smoke.HOME_EXT, "mem_requester_fill"):
        assert stats[name]["checks"] > 0, name
        assert stats[name]["max_abs_err"] == 0, name
