"""The memory engine step by step: graphite_tpu_torch (CPU) against
graphite_tpu on JAX states carried across by convert.py.

States: every quantum boundary of short lax_barrier runs of the coherence
stress trace (requests queued behind busy homes, evictions, INV / FLUSH /
WB fan-outs and acks in flight), with the caches' DVFS domains split so
that the synchronization delays are not zero, and with a tiny directory
(NULLIFY).  On each state:
 - the whole engine iteration (`memory_engine_step`, phases 1-6): the
   JAX engine as the Simulator builds it (consolidated, gated) against
   the port's;
 - each of phases 2-6 (the JAX package's module-level phase functions,
   direct form) against the port's plain versions, in the engine's
   order within the iteration.
Phase 1 exists in the JAX package only inside `memory_engine_step`, so
the whole-iteration comparison holds it; the per-phase comparisons start
from the port's phase 1 handed back to the JAX package.  Every MemState
leaf, the completion mask and the progress must be equal.  Tolerance:
zero.
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
from graphite_tpu.memory import engine as je
from graphite_tpu.memory.state import (
    MOD_DIR, MOD_L1D, MOD_L2, MOD_NET_MEM,
)
from graphite_tpu.time_types import cycles_to_ps
from graphite_tpu.trace import synthetic as j_syn

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.convert import mem_state_from_arrays
from graphite_tpu_torch.convert import trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.memory import engine as te
from graphite_tpu_torch.memory.context import MemCtx, MemRec
from graphite_tpu_torch.ops.mem_home_start import mem_home_start_plain
from graphite_tpu_torch.ops.mem_requester_fill import (
    mem_requester_fill_plain,
)
import torch_threads  # noqa: F401  (one intra-op thread)


SPLIT_DOMAINS = """
[dvfs]
synchronization_delay = 2
domains = "<1.0, CORE, L1_ICACHE, L1_DCACHE, NETWORK_USER><0.5, L2_CACHE, DIRECTORY, NETWORK_MEMORY>"
"""
TINY_DIR = "[dram_directory]\ntotal_entries = 32\nassociativity = 2\n"
I32_WORDS = ("sharers", "pending")


def states(extra, n_states=6):
    """(JAX simulator, port simulator, [JAX SimState numpy trees]) at the
    first quantum boundaries of a 16-tile coherence stress run."""
    text = config_text(16, shared_mem=True,
                       network="emesh_hop_counter") + extra
    text = text.replace("quantum = 1000", "quantum = 40")
    batch = j_syn.memory_stress_trace(16, n_accesses=40,
                                      working_set_bytes=1 << 12,
                                      write_fraction=0.4,
                                      shared_fraction=0.6, seed=5)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu")
    out = []
    for _ in range(n_states):
        done, _ = js.run_chunk(2)
        out.append(jax.device_get(js.state))
        if done:
            break
    return js, ts, out


def assert_mem_equal(jms, tms, where):
    """Every leaf of the port's MemState equals the JAX MemState's."""
    import dataclasses

    def walk(t, j, path):
        if isinstance(t, torch.Tensor):
            a = np.asarray(j)
            if a.dtype == np.uint32:
                a = (a.view(np.int32) if path.split(".")[-1] in I32_WORDS
                     else a.astype(np.int64))
            np.testing.assert_array_equal(a, t.numpy(),
                                          err_msg=f"{where}: {path}")
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                sub = getattr(t, f.name)
                if sub is not None:
                    walk(sub, getattr(j, f.name), f"{path}.{f.name}")

    walk(tms, jms, "mem")


def record_inputs(js, st):
    """The engine's per-lane inputs from a JAX state, as the step fetches
    them: (op, flags, pc, addr0, addr1, aux0, aux1, active) numpy."""
    tr = js.trace_batch
    T, L = tr.op.shape
    idx = np.minimum(np.asarray(st.core.idx), L - 1)
    rows = np.arange(T)
    f = {n: np.asarray(getattr(tr, n))[rows, idx]
         for n in ("op", "flags", "pc", "addr0", "addr1", "aux0", "aux1")}
    op = f["op"].astype(np.int32)
    done = np.asarray(st.done) | (op == 255) | (op == 45)
    f["active"] = ~done
    return f


def port_lanes(rec, T):
    lanes = Lanes.zeros(T, "cpu")
    lanes.op.copy_(torch.from_numpy(rec["op"].astype(np.int32)))
    lanes.flags.copy_(torch.from_numpy(rec["flags"].astype(np.int32)))
    lanes.pc.copy_(torch.from_numpy(rec["pc"].astype(np.int64)))
    lanes.aux0.copy_(torch.from_numpy(rec["aux0"].astype(np.int32)))
    lanes.aux1.copy_(torch.from_numpy(rec["aux1"].astype(np.int32)))
    lanes.active.copy_(torch.from_numpy(rec["active"]))
    return lanes


class _Core:
    def __init__(self, st):
        self.idx = torch.from_numpy(np.array(st.core.idx))
        self.clock_ps = torch.from_numpy(np.array(st.core.clock_ps))
        self.freq_mhz = torch.from_numpy(np.array(st.core.freq_mhz))


@pytest.mark.parametrize("variant", ["split_domains", "tiny_directory"])
def test_engine_iteration_equal(variant):
    extra = SPLIT_DOMAINS if variant == "split_domains" else TINY_DIR
    js, ts, sts = states(extra)
    mp = js.params.mem
    ctx = MemCtx(ts.params.mem, "cpu")
    T = mp.n_tiles
    events = 0
    for k, st in enumerate(sts):
        rec = record_inputs(js, st)
        enabled = jnp.asarray(st.models_enabled)
        out = je.memory_engine_step(
            mp, jax.tree_util.tree_map(jnp.asarray, st.mem),
            je.RecView(op=jnp.asarray(rec["op"].astype(np.int32)),
                       flags=jnp.asarray(rec["flags"].astype(np.int32)),
                       pc=jnp.asarray(rec["pc"]),
                       addr0=jnp.asarray(rec["addr0"]),
                       addr1=jnp.asarray(rec["addr1"]),
                       aux0=jnp.asarray(rec["aux0"]),
                       aux1=jnp.asarray(rec["aux1"])),
            jnp.asarray(st.core.clock_ps), jnp.asarray(st.core.freq_mhz),
            jnp.asarray(rec["active"]), enabled)
        tms = mem_state_from_arrays(st.mem, "cpu")
        lanes = port_lanes(rec, T)
        progress = torch.zeros(1, dtype=torch.int32)
        mem_ok = torch.zeros(T, dtype=torch.bool)
        te.memory_engine_step(ctx, tms, lanes, ts.device_trace, _Core(st),
                              torch.tensor(bool(st.models_enabled)),
                              progress, mem_ok)
        assert_mem_equal(jax.device_get(out.ms), tms, f"state {k}")
        np.testing.assert_array_equal(np.asarray(out.mem_complete), mem_ok)
        assert int(out.progress) == int(progress)
        events += int(progress)
    assert events > 0


PHASES = ("home_evictions", "home_starts", "sharer_step",
          "home_acks_and_finish", "requester_fill")


def to_jax(t, like):
    """A port MemState (or node, or leaf) as the JAX package's, shaped like
    `like` (the JAX-only leaves keep `like`'s values)."""
    import dataclasses

    if isinstance(t, torch.Tensor):
        a, dt = t.numpy(), np.asarray(like).dtype
        if dt == np.uint32:
            a = a.view(np.uint32) if a.dtype == np.int32 else a.astype(dt)
        return jnp.asarray(a.astype(dt))
    return like.replace(**{
        f.name: to_jax(getattr(t, f.name), getattr(like, f.name))
        for f in dataclasses.fields(t) if getattr(t, f.name) is not None})


@pytest.mark.parametrize("phase", PHASES)
def test_phase_equal(phase):
    """From each quantum boundary: the port's phase 1 (checked whole by
    test_engine_iteration_equal), its result handed to the JAX package,
    then phases 2-6 side by side — JAX's module-level phase functions on
    JAX's states, the port's on the port's — up to `phase`, every phase's
    state and progress equal."""
    from graphite_tpu_torch.ops.mem_requester import mem_requester_plain

    js, ts, sts = states(SPLIT_DOMAINS + TINY_DIR, n_states=8)
    mp = js.params.mem
    ctx = MemCtx(ts.params.mem, "cpu")
    T = mp.n_tiles
    upto = PHASES.index(phase)
    events = 0
    for k, st in enumerate(sts):
        en = jnp.asarray(st.models_enabled)
        fmhz = jnp.asarray(st.core.freq_mhz).astype(jnp.int64)
        i64 = jnp.int64

        def dps(n):
            return jnp.where(en, cycles_to_ps(jnp.asarray(n, i64),
                                              mp.dir_freq_mhz), 0)

        def cps(n):
            return jnp.where(en, cycles_to_ps(jnp.asarray(n, i64), fmhz), 0)

        dram = jnp.where(en, (mp.dram_latency_ns + mp.dram_processing_ns)
                         * 1000, 0).astype(i64)
        acc = dps(mp.dir_access_cycles)
        sync_l2_net = cps(mp.sync_cycles(MOD_L2, MOD_NET_MEM))
        zero = jnp.zeros((), jnp.int32)
        rec = record_inputs(js, st)
        lanes = port_lanes(rec, T)
        core = _Core(st)
        trec = MemRec.fetch(lanes, ts.device_trace, core.idx)
        tms = mem_state_from_arrays(st.mem, "cpu")
        ten = torch.tensor(bool(st.models_enabled))
        tf = core.freq_mhz.to(torch.int64)
        mem_requester_plain(ctx, tms, trec, core.clock_ps, tf, lanes.active,
                            ten, torch.zeros(1, dtype=torch.int32))
        jms = to_jax(tms, jax.tree_util.tree_map(jnp.asarray, st.mem))
        for name in PHASES[:upto + 1]:
            tprog = torch.zeros(1, dtype=torch.int32)
            if name == "home_evictions":
                jms, jp = je._home_evictions(mp, jms, acc, en, zero)
                te.home_evictions(ctx, tms, ten, tprog)
            elif name == "home_starts":
                jms, jp = je._home_starts(
                    mp, jms, dram, acc, dps(mp.sync_cycles(MOD_DIR, MOD_L2)),
                    dps(mp.sync_cycles(MOD_DIR, MOD_NET_MEM)), en, zero)
                mem_home_start_plain(ctx, tms, ten, tprog)
            elif name == "sharer_step":
                jms, jp = je._sharer_step(
                    mp, jms, fmhz, en, zero, sync_l2_net,
                    cps(mp.sync_cycles(MOD_L1D, MOD_L2)))
                te.sharer_step(ctx, tms, ctx.cycle_ps(tf, ten), ten, tprog)
            elif name == "home_acks_and_finish":
                jms, jp = je._home_acks_and_finish(mp, jms, dram, acc, en,
                                                   zero)
                te.home_acks_and_finish(ctx, tms, ten, tprog)
            else:
                jrec = je.RecView(
                    op=jnp.asarray(rec["op"].astype(np.int32)),
                    flags=jnp.asarray(rec["flags"].astype(np.int32)),
                    pc=jnp.asarray(rec["pc"]),
                    addr0=jnp.asarray(rec["addr0"]),
                    addr1=jnp.asarray(rec["addr1"]),
                    aux0=jnp.asarray(rec["aux0"]),
                    aux1=jnp.asarray(rec["aux1"]))
                jms, jp = je._requester_fill(
                    mp, jms, jrec, jnp.asarray(st.core.clock_ps), fmhz, en,
                    zero, sync_l2_net)
                mem_requester_fill_plain(ctx, tms, trec, core.clock_ps, tf,
                                         ten, tprog,
                                         torch.zeros(T, dtype=torch.bool))
            assert_mem_equal(jax.device_get(jms), tms, f"{name}, state {k}")
            assert int(jp) == int(tprog), f"{name}, state {k}"
        events += int(jp)
    assert events > 0, f"{phase} did nothing on every state"
