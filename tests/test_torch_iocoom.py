"""The iocoom core: graphite_tpu_torch (CPU) against graphite_tpu.

 - `iocoom_commit` step by step: random scoreboards, queue rings, records
   and memory latencies (numpy, from a seed) through the JAX function and
   the port's plain version, both queue options each way;
 - whole runs: iocoom tiles without a memory subsystem, with registers
   chained through loads, and a mixed `[tile] model_list` (iocoom and
   simple tiles) with and without memory;
 - a JAX iocoom + MSI run handed to the port mid-run (convert.py) and
   finished there.
Every SimResults field, `detailed_stalls` included, must be equal.
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
from graphite_tpu.models import iocoom as j_ioc
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.convert import state_from_arrays, trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.models.iocoom import (
    NUM_REGISTERS, IocoomParams, init_iocoom_state,
)
from graphite_tpu_torch.ops.iocoom_commit import iocoom_commit_plain

from test_torch_memory import assert_results_equal, run_both


def _random_case(seed, T=24, LQ=8, SQ=8):
    rng = np.random.default_rng(seed)
    reg_ready = rng.integers(0, 5000, (T, NUM_REGISTERS)).astype(np.int64)
    reg_unit = rng.choice(np.array([0, 1, 3], np.uint8), (T, NUM_REGISTERS))
    lq = rng.integers(0, 5000, (T, LQ)).astype(np.int64)
    sq = rng.integers(0, 5000, (T, SQ)).astype(np.int64)
    sq_addr = rng.integers(-1, 6, (T, SQ)).astype(np.int32)
    lq_idx = rng.integers(0, 100, T).astype(np.int32)
    sq_idx = rng.integers(0, 100, T).astype(np.int32)
    clock = rng.integers(0, 4000, T).astype(np.int64)
    freq = rng.choice(np.array([333, 1000, 2000], np.int64), T)
    cost = rng.integers(0, 3000, T).astype(np.int64)
    flags = rng.integers(0, 256, T).astype(np.int32)
    regs = [np.where(rng.random(T) < 0.2, 0xFFFF,
                     rng.integers(0, 600, T)).astype(np.int32)
            for _ in range(3)]
    addrs = [(rng.integers(0, 6, T) * 64 + rng.integers(0, 64, T))
             .astype(np.uint32) for _ in range(2)]
    lat = rng.integers(0, 3000, (T, 3)).astype(np.int64)
    op = rng.choice(np.array([1, 2, 11, 15, 32, 50], np.int32), T)
    active = rng.random(T) < 0.85
    mem_ok = rng.random(T) < 0.85
    ioc_tile = rng.random(T) < 0.8
    return dict(reg_ready=reg_ready, reg_unit=reg_unit, lq=lq, sq=sq,
                sq_addr=sq_addr, lq_idx=lq_idx, sq_idx=sq_idx, clock=clock,
                freq=freq, cost=cost, flags=flags, regs=regs, addrs=addrs,
                lat=lat, op=op, active=active, mem_ok=mem_ok,
                ioc_tile=ioc_tile)


@pytest.mark.parametrize("spec", [True, False])
@pytest.mark.parametrize("rfo", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iocoom_commit_random_states_equal(seed, rfo, spec):
    c = _random_case(seed)
    T = c["clock"].shape[0]
    kw = dict(speculative_loads_enabled=spec,
              multiple_outstanding_rfos_enabled=rfo)
    jp, tp = j_ioc.IocoomParams(**kw), IocoomParams(**kw)
    commit = c["active"] & (c["op"] < 15) & c["mem_ok"] & c["ioc_tile"]
    jst = j_ioc.init_iocoom_state(T, jp).replace(
        reg_ready_ps=jnp.asarray(c["reg_ready"]),
        reg_unit=jnp.asarray(c["reg_unit"]),
        lq_dealloc_ps=jnp.asarray(c["lq"]), lq_idx=jnp.asarray(c["lq_idx"]),
        sq_dealloc_ps=jnp.asarray(c["sq"]), sq_addr=jnp.asarray(c["sq_addr"]),
        sq_idx=jnp.asarray(c["sq_idx"]))
    jnew, jclock, jmem, jexe = j_ioc.iocoom_commit(
        jp, jst, commit=jnp.asarray(commit),
        clock_ps=jnp.asarray(c["clock"]), freq_mhz=jnp.asarray(c["freq"]),
        cost_ps=jnp.asarray(c["cost"]), flags=jnp.asarray(c["flags"]),
        rreg0=jnp.asarray(c["regs"][0]), rreg1=jnp.asarray(c["regs"][1]),
        wreg=jnp.asarray(c["regs"][2]), addr0=jnp.asarray(c["addrs"][0]),
        addr1=jnp.asarray(c["addrs"][1]),
        slot_lat_ps=jnp.asarray(c["lat"]), enabled=jnp.asarray(True))

    def t(a, dtype=None):
        x = torch.from_numpy(np.array(a))
        return x if dtype is None else x.to(dtype)

    ioc = init_iocoom_state(T, tp, "cpu")
    ioc.reg_ready_ps.copy_(t(c["reg_ready"]))
    ioc.reg_unit.copy_(t(c["reg_unit"]))
    ioc.lq_dealloc_ps.copy_(t(c["lq"]))
    ioc.lq_idx.copy_(t(c["lq_idx"]))
    ioc.sq_dealloc_ps.copy_(t(c["sq"]))
    ioc.sq_addr.copy_(t(c["sq_addr"]))
    ioc.sq_idx.copy_(t(c["sq_idx"]))
    lanes = Lanes.zeros(T, "cpu")
    lanes.op.copy_(t(c["op"]))
    lanes.flags.copy_(t(c["flags"]))
    lanes.active.copy_(t(c["active"]))
    lanes.mem_ok.copy_(t(c["mem_ok"]))
    lanes.cost_ps.copy_(t(c["cost"]))
    iocoom_commit_plain(
        tp, ioc, lanes, t(c["ioc_tile"]), t(c["clock"]),
        t(c["freq"], torch.int32), tuple(t(r) for r in c["regs"]),
        tuple(t(a.astype(np.int64)) for a in c["addrs"]), t(c["lat"]),
        torch.tensor(True))
    jnew = jax.device_get(jnew)
    for name in ("reg_ready_ps", "reg_unit", "lq_dealloc_ps", "lq_idx",
                 "sq_dealloc_ps", "sq_addr", "sq_idx", "load_queue_stall_ps",
                 "store_queue_stall_ps", "l1icache_stall_ps",
                 "intra_ins_l1dcache_stall_ps", "inter_ins_l1dcache_stall_ps",
                 "intra_ins_execution_unit_stall_ps",
                 "inter_ins_execution_unit_stall_ps"):
        np.testing.assert_array_equal(np.asarray(getattr(jnew, name)),
                                      getattr(ioc, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(jclock), lanes.ioc_clock)
    np.testing.assert_array_equal(np.asarray(jmem), lanes.ioc_mem_stall)
    np.testing.assert_array_equal(np.asarray(jexe), lanes.ioc_exec_stall)


def register_chain_batch(n_tiles=4):
    """Loads writing registers that the next records read, stores, and
    compute between them: the scoreboard and both queues at work."""
    bs = []
    for t in range(n_tiles):
        b = TraceBuilder()
        for i in range(30):
            a = 0x10000 * (t + 1) + (i % 9) * 64
            b.load(a, 8, wreg=i % 7, rregs=(((i + 3) % 7),))
            b.instr(Op.FMUL, rregs=(i % 7, (i + 1) % 7), wreg=(i + 2) % 7)
            if i % 3 == 0:
                b.store(a + 8, 8, rregs=((i + 2) % 7,))
            b.load_store(a + 16, a + 4096, 8)
        bs.append(b)
    return TraceBatch.from_builders(bs)


def ioc_text(n, shared_mem=True, model_list=None, extra=""):
    text = config_text(n, core="iocoom", shared_mem=shared_mem,
                       clock_scheme="lax")
    if model_list is not None:
        text = text.replace(f"model_list = <{n}, iocoom>",
                            f"model_list = {model_list}")
    return text + extra


@pytest.mark.parametrize("case", [
    "no_memory_fft", "no_memory_registers", "registers", "mixed_memstress",
    "mixed_fft", "mixed_no_memory", "fifo_queues"])
def test_iocoom_runs_equal(case):
    mixed = "<2, iocoom><2, simple>"
    if case == "no_memory_fft":
        text, batch = ioc_text(16, shared_mem=False), j_fft(16, 64)
    elif case == "no_memory_registers":
        text, batch = ioc_text(4, shared_mem=False), register_chain_batch()
    elif case == "registers":
        text, batch = ioc_text(4), register_chain_batch()
    elif case == "mixed_memstress":
        text = ioc_text(4, model_list=mixed)
        batch = j_syn.memory_stress_trace(4, n_accesses=60,
                                          working_set_bytes=1 << 12,
                                          write_fraction=0.4,
                                          shared_fraction=0.5, seed=3)
    elif case == "mixed_fft":
        text = ioc_text(16, model_list="<8, iocoom><8, simple>")
        batch = j_fft(16, 32, use_memory=True)
    elif case == "mixed_no_memory":
        text = ioc_text(4, shared_mem=False, model_list=mixed)
        batch = register_chain_batch()
    else:
        text = ioc_text(4, extra="[core/iocoom]\n"
                        "speculative_loads_enabled = false\n"
                        "multiple_outstanding_RFOs_enabled = false\n")
        batch = register_chain_batch()
    jr, tr, js, ts = run_both(text, batch, census=False)
    assert tr.detailed_stalls is not None
    assert (tr.mem_counters is None) == (case.startswith("no_memory")
                                         or case == "mixed_no_memory")
    if case.startswith("mixed"):
        assert ts.models.ioc_tile.tolist() == list(js.params.iocoom_tiles)


def test_jax_run_continued_in_the_port():
    """A JAX iocoom + MSI run stopped after some quanta and handed to the
    port (convert.state_from_arrays, memory and iocoom state included)
    finishes equal to the JAX run."""
    text = config_text(16, core="iocoom", shared_mem=True).replace(
        "quantum = 1000", "quantum = 20")                    # lax_barrier
    batch = j_syn.memory_stress_trace(16, n_accesses=40,
                                      working_set_bytes=1 << 13,
                                      write_fraction=0.4,
                                      shared_fraction=0.5, seed=7)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    all_done, n = js.run_chunk(3)
    assert not all_done
    mid = jax.device_get(js.state)
    jr = js.run()
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu")
    ts.state = state_from_arrays(mid, "cpu")
    tr = ts.run()
    for f in ("clock_ps", "instruction_count", "memory_stall_ps",
              "execution_stall_ps"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f), err_msg=f)
    for k in jr.mem_counters:
        np.testing.assert_array_equal(np.asarray(jr.mem_counters[k]),
                                      tr.mem_counters[k], err_msg=k)
    for k in jr.detailed_stalls:
        np.testing.assert_array_equal(np.asarray(jr.detailed_stalls[k]),
                                      tr.detailed_stalls[k], err_msg=k)
    assert jr.func_errors == tr.func_errors


def test_summary_has_the_iocoom_and_cache_sections():
    jr, tr, _, _ = run_both(ioc_text(4), register_chain_batch(),
                            census=False)
    s = tr.summary()
    assert "Detailed Stall Time Breakdown" in s and "Cache Summary:" in s
    assert_results_equal(jr, tr)
