"""graphite_tpu_torch host layer against graphite_tpu: config, trace
programs, time and integer helpers, network and DVFS tables.

Everything here is integer or string valued, so the tolerance is zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu import intmath as j_intmath
from graphite_tpu import time_types as j_time
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import auto_mailbox_depth as j_depth
from graphite_tpu.models import dvfs as j_dvfs
from graphite_tpu.models import network_user as j_net
from graphite_tpu.trace import benchmarks as j_bench
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.schema import TraceBuilder as JBuilder

from graphite_tpu_torch import intmath as t_intmath
from graphite_tpu_torch import time_types as t_time
from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.engine.simulator import auto_mailbox_depth as t_depth
from graphite_tpu_torch.models import dvfs as t_dvfs
from graphite_tpu_torch.models import network_user as t_net
from graphite_tpu_torch.trace import benchmarks as t_bench
from graphite_tpu_torch.trace import synthetic as t_syn
from graphite_tpu_torch.trace.schema import TraceBuilder as TBuilder
import torch_threads  # noqa: F401  (one intra-op thread)


CONFIGS = {
    "bench16": """
[general]
total_cores = 16
mode = lite
max_frequency = 1.0
[network]
user = emesh_hop_counter
memory = emesh_hop_counter
[network/emesh_hop_counter]
flit_width = 64
[network/emesh_hop_counter/router]
delay = 1
[network/emesh_hop_counter/link]
delay = 2
[core/static_instruction_costs]
generic = 1
ialu = 1
imul = 3
falu = 3
fmul = 5
[clock_skew_management]
scheme = lax
""",
    "dvfs_hetero": """
[general]
total_cores = 4
mode = lite
max_frequency = 2.0
technology_node = 45
[network]
user = magic
[dvfs]
domains = "<2.0, CORE, L1_ICACHE, L1_DCACHE>, <1.0, L2_CACHE, DIRECTORY, NETWORK_USER, NETWORK_MEMORY>"
synchronization_delay = 3   # trailing comment
[tile]
model_list = "<2, simple, T1, T1, T1>, <2, magic, default, T1, T1>"
[clock_skew_management]
scheme = lax_barrier
[clock_skew_management/lax_barrier]
quantum = 250
""",
}


def _batch_dict(batch):
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch)}


def _assert_batches_equal(jb, tb):
    jd, td = _batch_dict(jb), _batch_dict(tb)
    assert jd.keys() == td.keys()
    for k in jd:
        assert jd[k].dtype == td[k].dtype, k
        np.testing.assert_array_equal(jd[k], td[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simconfig_fields_equal(name):
    text = CONFIGS[name]
    jc = JSimConfig(JConfigFile.from_string(text))
    tc = TSimConfig(TConfigFile.from_string(text))
    assert jc.cfg.as_dict() == tc.cfg.as_dict()
    for attr in ("application_tiles", "num_processes", "enable_core_modeling",
                 "enable_shared_mem", "output_file", "max_frequency_mhz",
                 "technology_node", "total_tiles", "network_types",
                 "process_to_tiles", "tile_to_process", "mcp_tile_id"):
        assert getattr(jc, attr) == getattr(tc, attr), attr
    assert jc.mode.value == tc.mode.value
    assert ([dataclasses.astuple(s) for s in jc.tile_specs]
            == [dataclasses.astuple(s) for s in tc.tile_specs])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_network_and_dvfs_params_equal(name):
    text = CONFIGS[name]
    jc = JSimConfig(JConfigFile.from_string(text))
    tc = TSimConfig(TConfigFile.from_string(text))
    assert (dataclasses.asdict(j_net.UserNetworkParams.from_config(jc))
            == dataclasses.asdict(t_net.UserNetworkParams.from_config(tc)))
    assert (dataclasses.asdict(j_dvfs.DvfsParams.from_config(jc.cfg))
            == dataclasses.asdict(t_dvfs.DvfsParams.from_config(tc.cfg)))
    for module in ("CORE", "NETWORK_USER", "L2_CACHE"):
        assert (j_dvfs.module_freq_mhz(jc.cfg, module)
                == t_dvfs.module_freq_mhz(tc.cfg, module))


@pytest.mark.parametrize("n_tiles", [16, 64])
def test_fft_trace_equal(n_tiles):
    for ppt in (16, 64):
        _assert_batches_equal(j_bench.fft_trace(n_tiles, points_per_tile=ppt),
                              t_bench.fft_trace(n_tiles, points_per_tile=ppt))


@pytest.mark.parametrize("n_tiles", [16, 64])
@pytest.mark.parametrize("pattern", ["nearest_neighbor", "uniform_random",
                                     "transpose"])
def test_message_ring_batch_equal(n_tiles, pattern):
    for compressed in (False, True):
        kw = dict(n_rounds=5, compute_per_round=7, pattern=pattern,
                  compressed=compressed, cycles_per_instr=2)
        _assert_batches_equal(j_syn.message_ring_batch(n_tiles, **kw),
                              t_syn.message_ring_batch(n_tiles, **kw))


def test_trace_builder_equal():
    def build(B):
        bs = [B() for _ in range(3)]
        bs[0].instr(2, pc=8).branch(True, pc=0xFFFFFFF0).bblock(5, 9)
        bs[0].send(1, 64).recv(-1).barrier_init(0, 3).barrier_wait(0)
        bs[1].mutex_init(1).mutex_lock(1).mutex_unlock(1).cond_init(2)
        bs[1].cond_wait(2, 1).cond_signal(2, publish=True).cond_join(2, 1)
        bs[2].dvfs_set(0, 500, hold=True).syscall(3, 100).thread_join(0)
        bs[2].barrier_arrive(1).barrier_sync(1, 2).dynamic(19, 1234)
        return bs

    jb = type(j_bench.fft_trace(4)).from_builders(build(JBuilder))
    from graphite_tpu_torch.trace.schema import TraceBatch

    _assert_batches_equal(jb, TraceBatch.from_builders(build(TBuilder)))


@pytest.mark.parametrize("n_tiles", [16, 64])
def test_auto_mailbox_depth_equal(n_tiles):
    for jb, tb in (
            (j_bench.fft_trace(n_tiles, points_per_tile=32),
             t_bench.fft_trace(n_tiles, points_per_tile=32)),
            (j_syn.message_ring_batch(n_tiles, 6, pattern="uniform_random"),
             t_syn.message_ring_batch(n_tiles, 6,
                                      pattern="uniform_random"))):
        assert j_depth(jb) == t_depth(tb)


EDGE = np.array([-(2**40) - 7, -1001, -1000, -999, -7, -1, 0, 1, 6, 7, 8,
                 999, 1000, 1001, 2**40 + 3], np.int64)


@pytest.mark.parametrize("divisor", [1, 3, 7, 8, 1000, 1024, 333])
def test_intmath_truncates_like_lax(divisor):
    """Tensor forms truncate (lax.rem / lax.div); torch `%`/`//` would
    floor and differ on the negative operands here."""
    j = jnp.asarray(EDGE)
    t = torch.from_numpy(EDGE)
    for jf, tf in ((j_intmath.nn_mod, t_intmath.nn_mod),
                   (j_intmath.nn_div, t_intmath.nn_div),
                   (j_intmath.nn_ceil_div, t_intmath.nn_ceil_div)):
        np.testing.assert_array_equal(np.asarray(jf(j, divisor)),
                                      tf(t, divisor).numpy())
    # host ints keep Python's operators in both packages
    for x in EDGE.tolist():
        assert j_intmath.nn_mod(x, divisor) == t_intmath.nn_mod(x, divisor)
        assert j_intmath.nn_div(x, divisor) == t_intmath.nn_div(x, divisor)
    neg = torch.tensor([-7], dtype=torch.int64)
    if divisor in (3, 8):
        assert t_intmath.nn_mod(neg, divisor).item() != (neg % divisor).item()


@pytest.mark.parametrize("freq_mhz", [1, 333, 500, 999, 1000, 1001, 2000,
                                      3000])
def test_time_conversions_equal(freq_mhz):
    cycles = np.array([0, 1, 2, 3, 14, 999, 10**6, 2**33, -1, -3],
                      np.int64)
    np.testing.assert_array_equal(
        np.asarray(j_time.cycles_to_ps(jnp.asarray(cycles), freq_mhz)),
        t_time.cycles_to_ps(torch.from_numpy(cycles), freq_mhz).numpy())
    ps = np.array([0, 1, 999, 1000, 1001, 123456789], np.int64)
    np.testing.assert_array_equal(
        np.asarray(j_time.ps_to_ns(jnp.asarray(ps))),
        t_time.ps_to_ns(torch.from_numpy(ps)).numpy())
    for c in cycles.tolist():
        assert (j_time.cycles_to_ps(c, freq_mhz)
                == t_time.cycles_to_ps(c, freq_mhz))
    assert j_time.ns_to_ps(17) == t_time.ns_to_ps(17)
    assert j_time.ghz_to_mhz(1.234) == t_time.ghz_to_mhz(1.234)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_latency_equal(name):
    """Includes negative and huge payloads, where the int32 packet-bit
    arithmetic wraps and the flit division floors."""
    text = CONFIGS[name]
    jp = j_net.UserNetworkParams.from_config(
        JSimConfig(JConfigFile.from_string(text)))
    tp = t_net.UserNetworkParams.from_config(
        TSimConfig(TConfigFile.from_string(text)))
    rng = np.random.default_rng(3)
    T = JSimConfig(JConfigFile.from_string(text)).application_tiles
    src = rng.integers(0, T, 200).astype(np.int32)
    dst = rng.integers(0, T, 200).astype(np.int32)
    dst[:20] = src[:20]
    pay = rng.integers(-600, 5000, 200).astype(np.int32)
    pay[-10:] = [2**31 - 1, 2**30, 2**28 + 7, -(2**31), 268435455,
                 20_000_000, -65, -64, -63, 0]
    for enabled in (True, False):
        j = np.asarray(j_net.route_latency_ps(
            jp, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(pay),
            jnp.asarray(enabled)))
        t = t_net.route_latency_ps(
            tp, torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(pay), torch.tensor(enabled)).numpy()
        np.testing.assert_array_equal(j, t)
