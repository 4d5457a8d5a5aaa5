"""The shared-L2 protocols (`pr_l1_sh_l2_msi` / `_mesi`), whole runs:
graphite_tpu_torch (CPU) against graphite_tpu and the golden shared-L2
model.

Every scenario of tests/test_shl2.py on its config text, with that
test's own assertions held on the port's results; the shared-L2 cases of
tests/test_memory_golden.py (mutex-serialized RMWs, line-disjoint
streams, the MESI EXCLUSIVE grant / silent promote / WB downgrade, the
slice NULLIFY), where the port is held to `golden/memory_model_shl2.py`
as the JAX engine is; the iocoom core on shared-L2 MESI at 16 tiles; a
checkpoint of a shared-L2 run saved by one package and finished by the
other; and the statistics files of a shared-L2 run.  Every SimResults field, `n_quanta`, `last_n_iterations`, the
summary, the line census, the per-phase skip counts and every state leaf
the port carries must be equal.  Tolerance: zero (integer picoseconds
and counts).

The traces of one tile count are padded with IALU records to one length
(`pad`), so that one jitted JAX program serves them (`jax_run`).
"""

import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.system.checkpoint import load_checkpoint as j_load
from graphite_tpu.system.checkpoint import save_checkpoint as j_save
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.convert import state_to_arrays, trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.system import load_checkpoint, save_checkpoint

from test_memory_golden import make_config as golden_config
from test_memory_golden import mutex_rmw
from test_torch_memory import assert_golden, jax_run, run_both
from test_torch_state import _flat


MSI = "pr_l1_sh_l2_msi"
MESI = "pr_l1_sh_l2_mesi"


def shl2_text(n_tiles, protocol=MSI):
    """tests/test_shl2.py's make_config."""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
enable_shared_mem = true
[caching_protocol]
type = {protocol}
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
"""


def pad(batch, length):
    """`batch` with IALU records appended to `length` records a tile."""
    out = {}
    for k, v in batch.__dict__.items():
        v = np.asarray(v)
        fill = np.zeros((v.shape[0], length - v.shape[1]), v.dtype)
        if k == "op":
            fill[:] = int(Op.IALU)
        out[k] = np.concatenate([v, fill], axis=1)
    return TraceBatch(**out)


def run_shl2(text, batch, length=None, **kw):
    """run_both, the trace padded to `length`, with the skip counts and
    every state leaf held equal too."""
    if length is not None:
        batch = pad(batch, length)
    jr, tr, js, ts = run_both(text, batch, **kw)
    assert js.last_phase_skips == ts.last_phase_skips
    assert_states_equal(js, ts)
    return jr, tr, js, ts


def assert_states_equal(js, ts, skip=()):
    import jax

    a = _flat(jax.device_get(js.state))
    b = _flat(state_to_arrays(ts.state))
    assert set(b) <= set(a) and "mem.dir.word" in b
    for k in set(b) - set(skip):
        np.testing.assert_array_equal(a[k].astype(b[k].dtype), b[k],
                                      err_msg=k)


def batch(builders):
    return TraceBatch.from_builders(builders)


# --- tests/test_shl2.py's scenarios ----------------------------------------

def single_tile_store_load():
    b = TraceBuilder()
    b.store_value(0x40, 7)
    b.load_check(0x40, 7)
    return batch([b])


def producer_consumer():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x40, 42)
    b0.barrier_wait(0)
    b1.barrier_wait(0)
    b1.load_check(0x40, 42)
    return batch([b0, b1])


def write_invalidation_ping_pong():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x0, 1)
    b0.barrier_wait(0)
    b0.barrier_wait(0)
    b0.load_check(0x0, 2)
    b1.barrier_wait(0)
    b1.store_value(0x0, 2)
    b1.barrier_wait(0)
    return batch([b0, b1])


def read_sharers_then_upgrade():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.load_check(0x40, 0)
    b0.barrier_wait(0)
    b0.store_value(0x40, 5)
    b0.barrier_wait(0)
    b1.load_check(0x40, 0)
    b1.barrier_wait(0)
    b1.barrier_wait(0)
    b1.load_check(0x40, 5)
    return batch([b0, b1])


def four_tiles_one_line():
    builders = []
    for t in range(4):
        b = TraceBuilder()
        if t == 0:
            b.barrier_init(0, 4)
            b.store_value(0x80, 99)
        b.barrier_wait(0)
        b.load_check(0x80, 99)
        builders.append(b)
    return batch(builders)


def capacity_evictions():
    b = TraceBuilder()
    n_lines = 128 * 4 + 8
    for i in range(n_lines):
        b.store_value(i * 64, i)
    for i in range(0, n_lines, 7):
        b.load_check(i * 64, i)
    return batch([b, TraceBuilder()])


def lone_reader_then_write():
    b = TraceBuilder()
    b.load_check(0x40, 0)
    b.store_value(0x40, 3)
    b.load_check(0x40, 3)
    return batch([b, TraceBuilder()])


def second_reader_downgrades():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.load_check(0x0, 0)
    b0.barrier_wait(0)
    b1.barrier_wait(0)
    b1.load_check(0x0, 0)
    return batch([b0, b1])


def _check_single_tile(r):
    mc = r.mem_counters
    assert mc["l1d_write_misses"][0] == 1
    assert mc["l1d_read_hits"][0] == 1
    assert mc["dram_reads"].sum() == 1


def _check_producer_consumer(r):
    assert r.mem_counters["dram_reads"].sum() == 1


def _check_capacity(r):
    assert r.mem_counters["evictions"].sum() >= 1


def _check_exclusive_promote(r):
    mc = r.mem_counters
    assert mc["l1d_read_misses"][0] == 1
    assert mc["l1d_write_hits"][0] == 1
    assert mc["invalidations"].sum() == 0


def _check_msi_write_miss(r):
    assert r.mem_counters["l1d_write_misses"][0] == 1


# name -> (protocol, trace builder, the JAX test's own assertions)
SCENARIOS = {
    "single_tile_store_load": (MSI, single_tile_store_load,
                               _check_single_tile),
    "producer_consumer": (MSI, producer_consumer, _check_producer_consumer),
    "write_invalidation_ping_pong": (MSI, write_invalidation_ping_pong,
                                     None),
    "read_sharers_then_upgrade": (MSI, read_sharers_then_upgrade, None),
    "four_tiles_one_line": (MSI, four_tiles_one_line, None),
    "capacity_evictions": (MSI, capacity_evictions, _check_capacity),
    "mesi_lone_reader_exclusive_silent_upgrade": (
        MESI, lone_reader_then_write, _check_exclusive_promote),
    "msi_same_scenario_write_misses": (MSI, lone_reader_then_write,
                                       _check_msi_write_miss),
    "mesi_second_reader_downgrades_exclusive": (MESI,
                                                second_reader_downgrades,
                                                None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_shl2_scenario_equal(name):
    protocol, build, check = SCENARIOS[name]
    b = build()
    T, L = b.op.shape
    _, tr, _, _ = run_shl2(shl2_text(T, protocol), b,
                           length=max(L, 64) if L <= 64 else None)
    assert tr.func_errors == 0
    if check is not None:
        check(tr)


# --- tests/test_memory_golden.py's shared-L2 cases ---------------------------

def golden_disjoint():
    bs = [TraceBuilder() for _ in range(4)]
    for t, b in enumerate(bs):
        for i in range(80):
            addr = 0x100000 + (t * 80 + i) * 64
            (b.store if i % 3 == 0 else b.load)(addr, 8)
    return batch(bs)


def golden_exclusive_grant_and_promote():
    bs = [TraceBuilder() for _ in range(4)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(9, 4)
    for b in bs:
        b.barrier_wait(9)
    bs[0].mutex_lock(0)
    bs[0].load(0x900000, 8)
    bs[0].store(0x900000, 8)
    bs[0].mutex_unlock(0)
    bs[1].mutex_lock(0)
    bs[1].load(0x900000, 8)
    bs[1].mutex_unlock(0)
    bs[2].mutex_lock(0)
    bs[2].store(0x900000, 8)
    bs[2].mutex_unlock(0)
    return batch(bs)


def golden_slice_nullify():
    bs = [TraceBuilder() for _ in range(2)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(9, 2)
    for b in bs:
        b.barrier_wait(9)
    for i in range(6):
        bs[0].mutex_lock(0)
        bs[0].store(0x800000 + i * 2 * 64 * 64, 8)
        bs[0].mutex_unlock(0)
    return batch(bs)


NULLIFY_EXTRA = "[l2_cache/T1]\ncache_size = 4\nassociativity = 1\n"
# name -> (n_tiles, protocol, extra config, trace builder)
GOLDEN = {
    "serialized_msi": (4, MSI, "", lambda: mutex_rmw(4, rounds=6, lines=2)),
    "serialized_mesi": (4, MESI, "", lambda: mutex_rmw(4, rounds=6,
                                                       lines=2)),
    "disjoint_msi": (4, MSI, "", golden_disjoint),
    "disjoint_mesi": (4, MESI, "", golden_disjoint),
    "mesi_exclusive_grant_and_promote": (4, MESI, "",
                                         golden_exclusive_grant_and_promote),
    "slice_nullify_msi": (2, MSI, NULLIFY_EXTRA, golden_slice_nullify),
    "slice_nullify_mesi": (2, MESI, NULLIFY_EXTRA, golden_slice_nullify),
}


def golden_text(n, protocol, extra="", net="magic"):
    """tests/test_memory_golden.py's make_config as text."""
    sc = golden_config(n, protocol, net=net, extra=extra)
    return "".join(f"[{sec}]\n" + "".join(f"{k} = {v}\n"
                                          for k, v in keys.items())
                   for sec, keys in _sections(sc.cfg.as_dict()).items())


def _sections(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        sec, _, name = key.rpartition("/")
        out.setdefault(sec, {})[name] = v
    return out


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_shl2_golden_equal(case):
    n, protocol, extra, build = GOLDEN[case]
    text = golden_text(n, protocol, extra)
    b = build()
    _, tr, _, _ = run_shl2(text, b)
    assert_golden(text, b, tr)
    if case.startswith("disjoint"):
        assert int(tr.mem_counters["l2_misses"].sum()) > 0
    if case.startswith("slice_nullify"):
        assert int(tr.mem_counters["dram_writes"].sum()) > 0


def test_shl2_iocoom_mesi_16_tiles():
    """The iocoom core on shared-L2 MESI at 16 tiles (the 64-tile iocoom
    companion's config, cut to 16 tiles)."""
    text = config_text(16, core="iocoom", shared_mem=True,
                       clock_scheme="lax", protocol=MESI)
    b = j_fft(16, points_per_tile=16, use_memory=True)
    _, tr, _, _ = run_shl2(text, b)
    assert tr.detailed_stalls is not None
    assert int(tr.mem_counters["l2_misses"].sum()) > 0


def _port(text, b):
    return TSimulator(TSimConfig(TConfigFile.from_string(text)),
                      trace_from_arrays(b.__dict__), device="cpu")


def _jax(text, b):
    return JSimulator(JSimConfig(JConfigFile.from_string(text)), b)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_shl2_checkpoint_finished_by_the_other_package(saver, tmp_path):
    """A shared-L2 MESI run checkpointed mid-run by one package is
    finished by the other, equal to the uninterrupted JAX run (results
    and every state leaf)."""
    # a 20 ns quantum: the run takes several
    text = shl2_text(4, MESI).replace("quantum = 1000", "quantum = 20")
    b = mutex_rmw(4, rounds=4, lines=2)
    jref = _jax(text, b)
    r_ref = jax_run(jref)
    ck = str(tmp_path / "ck.npz")
    first = _jax(text, b) if saver == "jax" else _port(text, b)
    done, nq = first.run_chunk(2)
    assert not done
    (j_save if saver == "jax" else save_checkpoint)(first, ck, n_quanta=nq)
    second = _port(text, b) if saver == "jax" else _jax(text, b)
    assert (load_checkpoint if saver == "jax" else j_load)(second, ck) == nq
    r2 = second.run()
    for f in ("clock_ps", "instruction_count", "memory_stall_ps",
              "execution_stall_ps", "func_errors"):
        np.testing.assert_array_equal(getattr(r_ref, f), getattr(r2, f),
                                      err_msg=f)
    for k in r_ref.mem_counters:
        np.testing.assert_array_equal(r_ref.mem_counters[k],
                                      r2.mem_counters[k], err_msg=k)
    # a resumed run iterates more than an uninterrupted one (the chunk's
    # last block), so its phase-skip counts are not compared
    if saver == "jax":
        assert_states_equal(jref, second, skip=("mem.phase_skips",))
    else:
        import jax

        a = _flat(jax.device_get(jref.state))
        b2 = _flat(jax.device_get(second.state))
        for k in set(a) - {"mem.phase_skips"}:
            np.testing.assert_array_equal(a[k], b2[k], err_msg=k)


def test_shl2_statistics_files_equal(tmp_path):
    """The statistics manager over a shared-L2 run (its state has no
    line-utilization store): every `.trace` file byte-equal to the JAX
    package's."""
    import os

    from graphite_tpu.system.statistics import StatisticsManager as JStats
    from graphite_tpu.trace.benchmarks import canneal_trace as j_canneal

    from graphite_tpu_torch.system import StatisticsManager

    text = config_text(4, shared_mem=True, protocol=MESI,
                       clock_scheme="lax_barrier") + (
        "[statistics_trace]\nenabled = true\nstatistics = \""
        "cache_line_replication, network_utilization, "
        "cache_line_utilization\"\nsampling_interval = 2000\n"
        "[progress_trace]\nenabled = true\n")
    b = j_canneal(4, footprint_lines=16)
    jd, td = tmp_path / "jax", tmp_path / "port"
    JStats(_jax(text, b), output_dir=str(jd)).run()
    StatisticsManager(_port(text, b), output_dir=str(td)).run()
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td)) and len(names) >= 4
    for n in names:
        assert (jd / n).read_bytes() == (td / n).read_bytes(), n
