"""The memory slice, whole runs (continued): graphite_tpu_torch (CPU)
against graphite_tpu.

The 16-tile coherence stress trace; bench.py's 64-tile iocoom + MSI FFT
companion at reduced points and at its 512; lanes storing to one
functional word in one phase, and FLAG_CHECK errors; the port's
column-built traces against the JAX builders; configurations outside the
slice.  Equality as in test_torch_memory.py (zero tolerance, every
SimResults field, the summary, the line census where asked).
"""

import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.tools._template import config_text as j_config_text
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.trace import synthetic as t_syn
from graphite_tpu_torch.trace.benchmarks import fft_trace as t_fft
from graphite_tpu_torch.trace.schema import _FIELDS

from test_torch_memory import mem_text, run_both


def test_memstress16_equal():
    """The coherence stress trace (shared_fraction 0.5, write_fraction
    0.4): requests, evictions, INV / FLUSH / WB fan-outs and acks."""
    text = config_text(16, shared_mem=True, clock_scheme="lax")
    batch = j_syn.memory_stress_trace(16, n_accesses=80,
                                      working_set_bytes=1 << 13,
                                      write_fraction=0.4,
                                      shared_fraction=0.5, seed=7)
    jr, tr, _, _ = run_both(text, batch)
    assert int(tr.mem_counters["invalidations"].sum()) > 0


@pytest.mark.parametrize("points", [32, 512])
def test_companion_fft_equal(points):
    """bench.py's coherence companion: 64 iocoom tiles, MSI full_map,
    emesh_hop_counter, lax, the FFT with its loads, inner_block 64 — at
    reduced points and at the companion's 512."""
    text = config_text(64, core="iocoom", shared_mem=True,
                       clock_scheme="lax")
    assert text == j_config_text(64, core="iocoom", shared_mem=True,
                                 clock_scheme="lax")
    jr, tr, _, ts = run_both(text, j_fft(64, points, use_memory=True),
                             census=False, inner_block=64)
    assert tr.detailed_stalls is not None
    # every tile's first pass misses on its min(points, 32) private lines
    # (more where NULLIFY of a full directory set invalidated a line)
    assert int(tr.mem_counters["l2_misses"].sum()) >= 64 * min(points, 32)
    assert ts.params.n_follow(ts.device_trace.length) == 0


def one_word_batch():
    """Five tiles store different values to five lines 256 KB apart — one
    functional word — in the same iteration, cold (the stores complete in
    the fill phase) and warm (in the requester phase); tile 0 then loads
    the word with FLAG_CHECK against the highest tile's value."""
    bs = [TraceBuilder() for _ in range(5)]
    bs[0].barrier_init(0, 5)
    for b in bs:
        b.barrier_wait(0)
    base = 0x100000
    for r in range(2):
        for t, b in enumerate(bs):
            b.store_value(base + t * (256 << 10), 10 * r + t + 1)
        for b in bs:
            b.barrier_wait(0)
        bs[0].load_check(base, 10 * r + 5)
        for b in bs:
            b.barrier_wait(0)
    return TraceBatch.from_builders(bs)


def test_two_lanes_store_one_word():
    """Lanes that store to one functional word in one phase: the JAX
    scatter on the CPU keeps the highest lane's value, and so does the
    port (its kernels by a stamped atomicMax)."""
    jr, tr, _, _ = run_both(mem_text(5), one_word_batch())
    assert jr.func_errors == 0 and tr.func_errors == 0


def test_functional_checks_count_errors_equal():
    """A FLAG_CHECK load that reads another value counts one error, the
    same in both."""
    bs = [TraceBuilder() for _ in range(2)]
    bs[0].store_value(0x2000, 7).load_check(0x2000, 7).load_check(0x2000, 8)
    bs[1].store_value(0x4000, 1).load_check(0x4000, 2)
    jr, tr, _, _ = run_both(mem_text(2), TraceBatch.from_builders(bs))
    assert tr.func_errors == 2


@pytest.mark.parametrize("n_tiles", [16, 64])
@pytest.mark.parametrize("kind", ["fft", "memstress", "memstress_strided"])
def test_trace_builders_equal(n_tiles, kind):
    """The port's column-built traces equal the JAX package's
    record-by-record builders, field for field."""
    if kind == "fft":
        jb, tb = (j_fft(n_tiles, 512, use_memory=True),
                  t_fft(n_tiles, 512, use_memory=True))
    else:
        kw = (dict(n_accesses=50, stride=72) if kind == "memstress_strided"
              else dict(n_accesses=60, working_set_bytes=1 << 13,
                        write_fraction=0.4, shared_fraction=0.5, seed=7))
        jb = j_syn.memory_stress_trace(n_tiles, **kw)
        tb = t_syn.memory_stress_trace(n_tiles, **kw)
    for name, dtype in _FIELDS:
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype == dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("what", [
    "mosi", "shl2_msi", "shl2_mesi", "ackwise", "limited_no_broadcast",
    "limited_broadcast", "limitless", "hop_by_hop_memory", "atac_memory"])
def test_out_of_slice_configurations_raise(what):
    """Configurations outside the slice raise NotImplementedError naming
    their ROADMAP.md item.  The shared-L2 protocols run since the
    shared-L2 slice, so each case keeps its shared-L2 configuration
    ("mosi" the four-state shared-L2 protocol (MESI) at k = 4, each
    scheme under the shared-L2 MSI, each contention MEMORY net under the
    shared-L2 MESI) and asks for a feature still unported with it: trace
    streaming (item 11)."""
    shl2_msi = "[caching_protocol]\ntype = pr_l1_sh_l2_msi\n"
    shl2_mesi = "[caching_protocol]\ntype = pr_l1_sh_l2_mesi\n"
    extra, item = {
        "mosi": (shl2_mesi + "[dram_directory]\nmax_hw_sharers = 4\n", 11),
        "shl2_msi": (shl2_msi, 11),
        "shl2_mesi": (shl2_mesi, 11),
        "hop_by_hop_memory": ("[network]\nmemory = emesh_hop_by_hop\n"
                              + shl2_mesi, 11),
        "atac_memory": ("[network]\nmemory = atac\n" + shl2_mesi, 11),
    }.get(what, (shl2_msi + f"[dram_directory]\ndirectory_type = {what}\n",
                 11))
    batch = t_syn.memory_stress_trace(4, n_accesses=5)
    sc = TSimConfig(TConfigFile.from_string(mem_text(4, extra=extra)))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TSimulator(sc, batch, device="cpu", stream=True)
