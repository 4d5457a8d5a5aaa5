"""The memory slice, whole runs: graphite_tpu_torch (CPU) against
graphite_tpu and the golden memory model.

The private-L1/L2 MSI directory protocol with a full_map directory, on
the workloads of tests/test_memory_golden.py that run on it (their
builders imported from that module): single-tile random, disjoint
working sets, mutex-serialised sharing, WB downgrade, NULLIFY on a tiny
directory, the hop-counter memory net, icache modeling, round-robin
replacement, heterogeneous cache geometries, miss types,
`requester_unroll`, line utilisation; the staged JAX programs; the JAX
gates (test_torch_memory_runs.py has the stress trace, the companion and
the rest).  Every SimResults field (`mem_counters`,
`func_errors`, `detailed_stalls` included), `n_quanta`,
`last_n_iterations`, the summary and the line census must be equal.
Tolerance: zero (integer picoseconds and counts).  Where the JAX test
holds the engine to `golden/memory_model.py`, the port is held to it
too.
"""

import copy
import hashlib

import jax
import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.golden import run_golden
from graphite_tpu.memory.engine import line_census as j_line_census
from graphite_tpu.memory.engine_shl2 import (
    shl2_line_census as j_shl2_line_census,
)
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.schema import NO_REG, Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator

from test_memory_golden import (
    line_stream, mutex_rmw, share_then_write, wb_pattern,
)
import torch_threads  # noqa: F401  (one intra-op thread)


RESULT_FIELDS = (
    "n_tiles", "completion_time_ps", "instruction_count", "clock_ps",
    "memory_stall_ps", "execution_stall_ps", "recv_instructions",
    "recv_stall_ps", "sync_instructions", "sync_stall_ps", "bp_correct",
    "bp_incorrect", "packets_sent", "packets_received",
    "total_packet_latency_ps", "n_quanta", "func_errors")


def mem_text(n_tiles, net="magic", extra=""):
    """tests/test_memory_golden.py's make_config, MSI."""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
enable_shared_mem = true
[network]
user = magic
memory = {net}
[network/emesh_hop_counter]
flit_width = 64
[network/emesh_hop_counter/router]
delay = 1
[network/emesh_hop_counter/link]
delay = 1
[caching_protocol]
type = pr_l1_pr_l2_dram_directory_msi
[core/static_instruction_costs]
mov = 1
ialu = 1
{extra}
"""


def trace_lines(batch, line_bits=6, limit=64) -> list:
    """The lines the trace's memory operands touch (the census's lines)."""
    flags = np.asarray(batch.flags)
    lines = set()
    for k, f in ((0, "addr0"), (1, "addr1")):
        m = (flags & (1 << k)) != 0
        lines |= set((np.asarray(getattr(batch, f))[m].astype(np.int64)
                      >> line_bits).tolist())
    return sorted(lines)[:limit]


def assert_results_equal(jr, tr, where=""):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      np.asarray(getattr(tr, f)),
                                      err_msg=f"{where}: {f}")
    for f in ("mem_counters", "detailed_stalls"):
        a, b = getattr(jr, f), getattr(tr, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.keys() == b.keys(), f
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                              err_msg=f"{where}: {f}.{k}")
    for f in ("telemetry", "profile", "hist"):
        assert getattr(jr, f) is None and getattr(tr, f) is None, f
    assert jr.summary() == tr.summary()


# jitted JAX programs with the trace as an argument, newest last
_PROGRAMS: dict = {}
# what those programs returned in this process, by program and inputs,
# newest last
_RESULTS: dict = {}


def inputs_digest(tree) -> str:
    """A digest of a pytree's structure and every leaf's dtype, shape and
    bytes (the inputs of one program run)."""
    h = hashlib.sha256(str(jax.tree_util.tree_structure(tree)).encode())
    for leaf in jax.tree_util.tree_leaves(jax.device_get(tree)):
        a = np.asarray(leaf)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# the record count a shorter JAX trace is padded to (`padded_records`)
MIN_RECORDS = 32


def padded_records(trace):
    """A JAX DeviceTrace of fewer than MIN_RECORDS records a tile padded
    to that many by NOP records, as the JAX package pads a stream past its
    end (`DeviceTrace.window`): every tile has ended at its THREAD_EXIT
    before them.  The short traces of one config then share one program
    (a longer trace would only run slower; it stays as it is)."""
    L = trace.op.shape[1]
    n = max(L, MIN_RECORDS)
    if n == L:
        return trace

    def pad(name, a):
        # on the host: an eager jnp.pad compiles a program a field
        fill = (int(Op.NOP) if name == "op" else
                NO_REG if name in ("rreg0", "rreg1", "wreg") else 0)
        return jax.numpy.asarray(np.pad(np.asarray(a), ((0, 0), (0, n - L)),
                                        constant_values=fill))

    return trace.replace(**{name: pad(name, a) for name, a in
                            vars(trace).items()})


def jax_run(js, max_quanta: int = 1_000_000):
    """`js.run()` (a JAX Simulator), with the trace as an argument of one
    jitted program per engine parameters, quantum and trace shape: run()
    closes over its trace, so every trace compiles a program of its own
    (~5-20 s each on the CPU), where traces of one length under one
    config share one here (short ones padded to one, `padded_records`).
    The same program, the same results; `js.state` and
    `js.last_n_iterations` are set as run() sets them.  A run whose
    program and inputs (state and trace) this process has run already
    returns that run's results without running again.  Runs that drive
    their quanta from the host, stream or record a timeline take run()."""
    specs = (js.telemetry_spec, js.profile_spec, js.dvfs_spec, js.hist_spec)
    if js.barrier_host or js.stream or js.mesh is not None or any(
            s is not None for s in specs):
        return js.run(max_quanta)
    fn, (state, trace) = js._auditable_fn(max_quanta)
    trace = padded_records(trace)
    key = repr((js.params, js.quantum_ps, max_quanta))
    run_key = (key, inputs_digest((state, trace)))
    if run_key in _RESULTS:
        js.state, js.last_n_iterations, results = _RESULTS[run_key]
        return copy.deepcopy(results)
    prog = _PROGRAMS.pop(key, None) or jax.jit(fn)
    _PROGRAMS[key] = prog
    while len(_PROGRAMS) > 8:
        _PROGRAMS.pop(next(iter(_PROGRAMS)))
    state, nq, dead, n_iters = prog(state, trace)
    net_part, mem_part, ioc_part = js._result_parts(state)[:3]
    (nq, dead, overflow, done, core_h, net_h, mem_h, ioc_h,
     n_iters) = jax.device_get((nq, dead, state.net.overflow, state.done,
                                state.core, net_part, mem_part, ioc_part,
                                n_iters))
    assert not bool(overflow) and not bool(dead) and bool(done.all())
    js.state = state
    js.last_n_iterations = n_iters
    results = js._results_host(core_h, net_h, mem_h, int(nq), ioc_h)
    _RESULTS[run_key] = (state, n_iters, copy.deepcopy(results))
    while len(_RESULTS) > 8:
        _RESULTS.pop(next(iter(_RESULTS)))
    return results


def census_of(js, lines) -> dict:
    """The JAX run's per-line census under either engine."""
    if js.params.mem.protocol.startswith("pr_l1_sh_l2"):
        return j_shl2_line_census(js.state.mem, js.params.mem, lines)
    return j_line_census(js.state.mem, js.params.mem, lines)


def run_both(text, batch, *, jax_kw=None, census=True, **kw):
    """The JAX run (with `jax_kw` too) and the port's CPU run of one config
    text and trace, held equal; returns (JAX results, port results, JAX
    simulator, port simulator)."""
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch,
                    **kw, **(jax_kw or {}))
    jr = jax_run(js)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu", **kw)
    tr = ts.run()
    assert_results_equal(jr, tr)
    assert js.last_n_iterations == ts.last_n_iterations
    if census:
        lines = trace_lines(batch, js.params.mem.line_bits)
        assert census_of(js, lines) == ts.line_census(lines)
    return jr, tr, js, ts


def assert_golden(text, batch, tr):
    """The port's run against golden/memory_model.py, as
    tests/test_memory_golden.py's assert_exact holds the JAX engine."""
    gold = run_golden(JSimConfig(JConfigFile.from_string(text)), batch)
    np.testing.assert_array_equal(tr.clock_ps, gold.clock_ps,
                                  err_msg="clock vs golden")
    for k, g in gold.mem_counters.items():
        np.testing.assert_array_equal(tr.mem_counters[k], g,
                                      err_msg=f"{k} vs golden")


def _icache_batch():
    b = TraceBuilder()
    for i in range(200):
        b.instr(Op.IALU, pc=0x4000 + (i % 40) * 64)
    return TraceBatch.from_builders([b])


def _round_robin_batch():
    b = TraceBuilder()
    lines = [0x400 + i * 128 for i in range(6)]   # all map to l1d set 0
    for r in range(4):
        for ln in lines:
            b.load(ln << 6, 8)
            b.load(lines[0] << 6, 8)
    return TraceBatch.from_builders([b])


def _miss_type_batch():
    """test_memory_golden.py test_miss_type_classification's trace."""
    bs = [TraceBuilder() for _ in range(2)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(9, 2)
    for b in bs:
        b.barrier_wait(9)
    for rep in range(2):
        for i in range(4):
            bs[0].mutex_lock(0)
            bs[0].load(0x100000 + i * 64 * 64, 8)
            bs[0].mutex_unlock(0)
    for b in bs:
        b.barrier_wait(9)
    for rep in range(3):
        bs[1].mutex_lock(0)
        bs[1].load(0x900000, 8)
        bs[1].mutex_unlock(0)
        for b in bs:
            b.barrier_wait(9)
        bs[0].mutex_lock(0)
        bs[0].store(0x900000, 8)
        bs[0].mutex_unlock(0)
        for b in bs:
            b.barrier_wait(9)
    return TraceBatch.from_builders(bs)


def _line_util_batch():
    """test_memory_golden.py test_cache_line_utilization_exact's trace."""
    bs = [TraceBuilder() for _ in range(4)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(9, 4)
    for b in bs:
        b.barrier_wait(9)
    X, Y = 0x900000, 0x900000 + 16 * 64
    for rep in range(2):
        for t, b in enumerate(bs):
            b.mutex_lock(0)
            for i in range(3):
                b.load(X, 8)
                b.load(Y, 8)
            b.store(X, 8)
            for i in range(3):
                b.load(0x100000 + t * 64 + i * 64 * 64, 8)
            b.mutex_unlock(0)
    return TraceBatch.from_builders(bs)


HETERO = """
[tile]
model_list = "<2, simple, T0, T0, T0><2, simple, T1, T1, T1>"
[l1_icache/T0]
cache_size = 4
associativity = 2
[l1_dcache/T0]
cache_size = 4
associativity = 2
data_access_time = 2
[l2_cache/T0]
cache_size = 32
associativity = 4
data_access_time = 5
tags_access_time = 2
"""

# name -> (n_tiles, memory net, extra config, trace builder, held to the
# golden model)
GOLDEN_CASES = {
    "single_tile_random": (1, "magic", "", lambda: j_syn.memory_stress_trace(
        1, n_accesses=300, working_set_bytes=1 << 16, seed=3), True),
    "disjoint_working_sets": (4, "magic", "",
                              lambda: j_syn.memory_stress_trace(
                                  4, n_accesses=150,
                                  working_set_bytes=1 << 15, seed=5), True),
    "mutex_serialized_sharing": (4, "magic", "", lambda: mutex_rmw(4, 6),
                                 True),
    "wb_downgrade": (2, "magic", "", wb_pattern, True),
    "share_then_write": (4, "magic", "", lambda: share_then_write(4), True),
    "nullify_tiny_directory": (
        1, "magic", "[dram_directory]\ntotal_entries = 16\nassociativity = 2\n",
        lambda: line_stream(64), True),
    "hop_counter_memory_net": (4, "emesh_hop_counter", "",
                               lambda: mutex_rmw(4, 5), True),
    "icache_modeling": (1, "magic",
                        "[general]\nenable_icache_modeling = true\n",
                        _icache_batch, True),
    "round_robin_replacement": (
        1, "magic", "[l1_dcache/T1]\nreplacement_policy = round_robin\n"
        "[l2_cache/T1]\nreplacement_policy = round_robin\n",
        _round_robin_batch, True),
    "heterogeneous_geometries_stress": (
        4, "magic", HETERO, lambda: j_syn.memory_stress_trace(
            4, n_accesses=150, working_set_bytes=1 << 14, seed=13), True),
    "heterogeneous_geometries_sharing": (4, "magic", HETERO,
                                         lambda: mutex_rmw(4, 5), True),
    "miss_types": (2, "magic", "[l2_cache/T1]\ncache_size = 4\n"
                   "associativity = 1\ntrack_miss_types = true\n",
                   _miss_type_batch, True),
    "requester_unroll": (4, "magic", "[general]\nrequester_unroll = 3\n",
                         lambda: mutex_rmw(4, rounds=5, lines=2), True),
    "line_utilization": (
        4, "magic", "[l1_dcache/T1]\ncache_size = 1\nassociativity = 1\n"
        "[l2_cache/T1]\ncache_size = 4\nassociativity = 1\n"
        "track_cache_line_utilization = true\n", _line_util_batch, True),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_golden_workload_equal(case):
    n, net, extra, build, golden = GOLDEN_CASES[case]
    text = mem_text(n, net, extra)
    batch = build()
    jr, tr, _, _ = run_both(text, batch)
    assert int(tr.mem_counters["l2_misses"].sum()) > 0
    if golden:
        assert_golden(text, batch, tr)


@pytest.mark.parametrize("case", ["staged_serialized", "staged_racy"])
def test_staged_jax_program_equal(case):
    """The JAX package's staged directory program (dir_stage=True,
    inner_block=4: many flush boundaries) gives what the port gives by
    writing in place, on serialised and on racy traffic."""
    if case == "staged_serialized":
        n, batch = 6, mutex_rmw(6, rounds=4)
    else:
        n, batch = 8, j_syn.memory_stress_trace(
            8, n_accesses=80, working_set_bytes=1 << 12,
            write_fraction=0.4, shared_fraction=0.6, seed=11)
    run_both(mem_text(n), batch, jax_kw={"dir_stage": True}, inner_block=4)


@pytest.mark.parametrize("gate", ["whole_engine", "phases"])
def test_gates_are_pure(gate):
    """The JAX step's whole-engine gate (mem_gate) and per-phase gates
    (phase_gate) change no result: a JAX run with the gate off equals the
    gated default, and the port (which evaluates no gate on the card)
    equals both."""
    text = mem_text(16)
    batch = j_syn.memory_stress_trace(16, n_accesses=60,
                                      working_set_bytes=1 << 13,
                                      write_fraction=0.4,
                                      shared_fraction=0.5, seed=7)
    off = ({"mem_gate_bytes": 0} if gate == "whole_engine"
           else {"phase_gate": False})
    jr_off, tr, _, _ = run_both(text, batch, jax_kw=off)
    jr_on = JSimulator(JSimConfig(JConfigFile.from_string(text)),
                       batch).run()
    assert_results_equal(jr_on, tr)
    assert_results_equal(jr_on, jr_off)
