"""What users read back: sim.out, checkpoints, statistics traces.

The port against graphite_tpu on the CPU, byte for byte where the JAX
package writes a file:

 - `Simulator.write_output`: `sim.out` and the `carbon_sim.cfg` snapshot;
 - `system.save_checkpoint` / `load_checkpoint`: the port's own round
   trip, a JAX checkpoint saved mid-run and finished by the port, a port
   checkpoint finished by the JAX package, and the wrong-topology
   `ValueError`;
 - `system.StatisticsManager` (chunked backend): every `.trace` file;
 - what is still out of the slice raises NotImplementedError naming its
   ROADMAP.md item: the device-timeline backend (12), the power trace (10).

The workloads are `tests/test_system.py`'s (MSI over magic nets, a
functional store and check per line).
"""

import os

import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.system import StatisticsManager as JStats
from graphite_tpu.system import load_checkpoint as j_load
from graphite_tpu.system import save_checkpoint as j_save
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.system import Log
from graphite_tpu_torch.system import StatisticsManager as TStats
from graphite_tpu_torch.system import load_checkpoint, save_checkpoint
from graphite_tpu_torch.system.statistics import chunk_quanta

from test_torch_memory import assert_results_equal


def make_text(n_tiles=4, extra=""):
    """tests/test_system.py's make_config."""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
enable_shared_mem = true
[network]
user = magic
memory = magic
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
[clock_skew_management]
scheme = lax_barrier
[clock_skew_management/lax_barrier]
quantum = 1000
{extra}
"""


def mem_workload(n_tiles=4, n=40):
    """tests/test_system.py's mem_workload."""
    builders = []
    for t in range(n_tiles):
        b = TraceBuilder()
        for i in range(n):
            b.store_value(t * 0x10000 + i * 64, i)
            b.load_check(t * 0x10000 + i * 64, i)
        builders.append(b)
    return TraceBatch.from_builders(builders)


def jax_sim(text, batch):
    return JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)


def port_sim(text, batch):
    return TSimulator(TSimConfig(TConfigFile.from_string(text)),
                      trace_from_arrays(batch.__dict__), device="cpu")


def read_all(d) -> dict:
    return {fn: open(os.path.join(d, fn), "rb").read()
            for fn in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def mem_runs():
    """The functional-store workload run to its end once by each package,
    as (text, batch, JAX simulator, its results, port simulator, its
    results): the uninterrupted runs the sim.out and checkpoint tests
    hold their files and resumed runs against."""
    text, batch = make_text(), mem_workload()
    js, ts = jax_sim(text, batch), port_sim(text, batch)
    return text, batch, js, js.run(), ts, ts.run()


def test_sim_out_and_config_snapshot_byte_equal(tmp_path, mem_runs):
    _, _, js, jr, ts, tr = mem_runs
    jout = js.write_output(jr, output_dir=str(tmp_path / "jax"))
    tout = ts.write_output(tr, output_dir=str(tmp_path / "port"))
    assert os.path.basename(jout) == os.path.basename(tout) == "sim.out"
    jfiles, tfiles = read_all(tmp_path / "jax"), read_all(tmp_path / "port")
    assert sorted(tfiles) == ["carbon_sim.cfg", "sim.out"]
    assert jfiles == tfiles
    assert b"Cache Summary" in tfiles["sim.out"]


def test_checkpoint_round_trip_and_resume(tmp_path, mem_runs):
    """The port saves mid-run, a new Simulator loads, and the run finishes
    equal to the uninterrupted one (and to the JAX package's); the loaded
    state equals the saved one leaf for leaf."""
    text, batch, _, jr, _, r_ref = mem_runs
    assert_results_equal(jr, r_ref)
    sim1 = port_sim(text, batch)
    done, nq = sim1.run_chunk(3)
    assert not done and nq == 3
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(sim1, ckpt, n_quanta=nq)
    sim2 = port_sim(text, batch)
    assert load_checkpoint(sim2, ckpt) == nq
    from graphite_tpu_torch.convert import checkpoint_arrays

    a, b = checkpoint_arrays(sim1.state), checkpoint_arrays(sim2.state)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    r2 = sim2.run()
    for f in ("clock_ps", "instruction_count", "memory_stall_ps"):
        np.testing.assert_array_equal(getattr(r_ref, f), getattr(r2, f))
    for k in r_ref.mem_counters:
        np.testing.assert_array_equal(r_ref.mem_counters[k],
                                      r2.mem_counters[k], err_msg=k)
    assert r2.func_errors == 0


def test_checkpoints_cross_between_packages(tmp_path, mem_runs):
    """A JAX checkpoint saved mid-run loads into the port, which finishes
    it bit-equal to JAX's uninterrupted run; and the JAX package resumes
    the port's checkpoint of the same point to the same end."""
    text, batch, _, r_ref, _, _ = mem_runs
    js = jax_sim(text, batch)
    done, nq = js.run_chunk(3)
    assert not done
    jck = str(tmp_path / "jax.npz")
    j_save(js, jck, n_quanta=nq)
    ts = port_sim(text, batch)
    assert load_checkpoint(ts, jck) == nq
    tck = str(tmp_path / "port.npz")
    save_checkpoint(ts, tck, n_quanta=nq)
    tr = ts.run()
    for f in ("clock_ps", "instruction_count", "memory_stall_ps",
              "execution_stall_ps"):
        np.testing.assert_array_equal(getattr(r_ref, f), getattr(tr, f), f)
    for k in r_ref.mem_counters:
        np.testing.assert_array_equal(r_ref.mem_counters[k],
                                      tr.mem_counters[k], err_msg=k)
    js2 = jax_sim(text, batch)
    assert j_load(js2, tck) == nq
    r2 = js2.run()
    np.testing.assert_array_equal(r_ref.clock_ps, r2.clock_ps)
    for k in r_ref.mem_counters:
        np.testing.assert_array_equal(r_ref.mem_counters[k],
                                      r2.mem_counters[k], err_msg=k)


def test_checkpoint_rejects_wrong_topology(tmp_path):
    sim4 = port_sim(make_text(4), mem_workload(4))
    ckpt = str(tmp_path / "c.npz")
    save_checkpoint(sim4, ckpt)
    sim2 = port_sim(make_text(2), mem_workload(2))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(sim2, ckpt)
    # a memoryless state's file lacks the memory leaves
    nomem = port_sim(make_text(4, "[general]\nenable_shared_mem = false"),
                     mem_workload(4))
    save_checkpoint(nomem, ckpt)
    with pytest.raises(ValueError, match="missing leaf"):
        load_checkpoint(port_sim(make_text(4), mem_workload(4)), ckpt)


STATS = """
[statistics_trace]
enabled = true
statistics = "cache_line_replication, network_utilization, cache_line_utilization"
sampling_interval = 2000
[progress_trace]
enabled = true
[l2_cache/T1]
track_cache_line_utilization = true
"""


@pytest.mark.parametrize("case", ["statistics", "progress_only", "fft"])
def test_statistics_files_byte_equal(tmp_path, case):
    """The chunked sampler's files (replication, utilization, both nets'
    rates, progress) equal the JAX package's byte for byte, and so do the
    results of the sampled run.  The FFT's loads (with its messages and
    a 1 KB L2, so lines are evicted and classified) fill every column."""
    extra, batch = STATS, mem_workload()
    if case == "progress_only":
        extra = STATS.replace("enabled = true\nstatistics",
                              "enabled = false\nstatistics")
    elif case == "fft":
        extra = STATS + "cache_size = 1\n"
        batch = j_fft(4, points_per_tile=64, use_memory=True)
    text = make_text(extra=extra)
    jst = JStats(jax_sim(text, batch), output_dir=str(tmp_path / "jax"),
                 backend="chunked")
    tst = TStats(port_sim(text, batch), output_dir=str(tmp_path / "port"))
    jr, tr = jst.run(), tst.run()
    assert_results_equal(jr, tr)
    jfiles, tfiles = read_all(tmp_path / "jax"), read_all(tmp_path / "port")
    assert jfiles == tfiles
    assert "progress.trace" in tfiles
    if case != "progress_only":
        assert {"cache_line_replication.trace",
                "cache_line_utilization.trace",
                "network_utilization_memory.trace",
                "network_utilization_user.trace"} <= set(tfiles)
    assert chunk_quanta(2000, 1_000_000) == 2


def test_out_of_slice_statistics_raise(tmp_path):
    """The device-timeline backend (ROADMAP item 12, the telemetry ring) —
    asked for, or picked by `auto` for counter-only statistics — and the
    power trace (item 10) raise; lax without quanta raises JAX's
    ValueError, and a backend the JAX package does not know raises too."""
    net_only = ("[statistics_trace]\nenabled = true\n"
                "statistics = network_utilization\n")
    batch = mem_workload()
    for backend in ("device", "auto"):
        with pytest.raises(NotImplementedError, match="item 12"):
            TStats(port_sim(make_text(extra=net_only), batch),
                   backend=backend)
    power = "[runtime_energy_modeling/power_trace]\nenabled = true\n"
    with pytest.raises(NotImplementedError, match="item 10"):
        TStats(port_sim(make_text(extra=power), batch))
    with pytest.raises(ValueError, match="device-timeline backend"):
        TStats(port_sim(make_text(extra=STATS), batch), backend="device")
    with pytest.raises(ValueError, match="unknown statistics backend"):
        TStats(port_sim(make_text(), batch), backend="ring")
    lax = make_text().replace("scheme = lax_barrier", "scheme = lax")
    with pytest.raises(ValueError, match="lax_barrier"):
        TStats(port_sim(lax, batch)).run()


def test_log_filters_and_files(tmp_path):
    cfg = TConfigFile.from_string(
        '[log]\nenabled = true\ndisabled_modules = "network"\n')
    log = Log(cfg, output_dir=str(tmp_path))
    assert log.is_logging_enabled("core")
    assert not log.is_logging_enabled("network")
    log.log("core", "hello", tile_id=2, sim_time_ns=123)
    log.log("network", "dropped", tile_id=2)
    log.close()
    text = (tmp_path / "tile_2.log").read_text()
    assert "hello" in text and "[123ns]" in text and "dropped" not in text
    with pytest.raises(AssertionError):
        log.assert_error(False, "core", "boom")
