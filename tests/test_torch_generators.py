"""The port's trace generators against graphite_tpu's, and three of them run.

Every `BENCHMARKS` generator (`bench.py`'s workloads) and
`ping_pong_trace` builds the same arrays in both packages, column for
column, at two sizes and — where the generator has the parameter — with
and without memory operands.  Then the BASELINE.json workloads the port
can run on one card go through both simulators at 16 tiles: blackscholes
on the headline config, canneal on MSI `full_map` under lax_barrier, and
ping-pong on `config_text(16)` (simple core, hop counter).  Tolerance:
zero.
"""

import inspect

import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.tools._template import config_text as j_config_text
from graphite_tpu.trace import benchmarks as j_bench
from graphite_tpu.trace import synthetic as j_syn

from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.trace import benchmarks as t_bench
from graphite_tpu_torch.trace import synthetic as t_syn
from graphite_tpu_torch.trace.schema import _FIELDS

from test_torch_engine import config_text as engine_text
from test_torch_memory import run_both


def assert_columns_equal(jb, tb, where):
    for name, dtype in _FIELDS:
        a, b = np.asarray(getattr(jb, name)), np.asarray(getattr(tb, name))
        assert a.dtype == b.dtype == np.dtype(dtype), (where, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def test_benchmark_names_equal():
    assert sorted(t_bench.BENCHMARKS) == sorted(j_bench.BENCHMARKS)


@pytest.mark.parametrize("name", sorted(j_bench.BENCHMARKS))
def test_generator_columns_equal(name):
    jfn, tfn = j_bench.BENCHMARKS[name], t_bench.BENCHMARKS[name]
    memory = ([False, True]
              if "use_memory" in inspect.signature(jfn).parameters
              else [None])
    for n_tiles in (4, 16):
        for mem in memory:
            kw = {} if mem is None else {"use_memory": mem}
            assert_columns_equal(jfn(n_tiles, **kw), tfn(n_tiles, **kw),
                                 f"{name}({n_tiles}, {kw})")


@pytest.mark.parametrize("n_tiles,rounds", [(2, 100), (16, 7)])
def test_ping_pong_columns_equal(n_tiles, rounds):
    assert_columns_equal(j_syn.ping_pong_trace(n_tiles, rounds, 16),
                         t_syn.ping_pong_trace(n_tiles, rounds, 16),
                         f"ping_pong({n_tiles})")
    with pytest.raises(ValueError):
        t_syn.ping_pong_trace(1)


def test_canneal_draws_in_the_jax_order():
    """Other seeds and footprints: the scalar draw order decides every
    address and branch."""
    for seed in (0, 99):
        assert_columns_equal(
            j_bench.canneal_trace(8, footprint_lines=64, swaps_per_tile=9,
                                  seed=seed),
            t_bench.canneal_trace(8, footprint_lines=64, swaps_per_tile=9,
                                  seed=seed), f"canneal seed {seed}")


@pytest.mark.parametrize("workload", ["blackscholes", "canneal",
                                      "ping_pong"])
def test_baseline_workloads_run_equal(workload):
    """Each workload at 16 tiles: every SimResults field, n_quanta,
    last_n_iterations (and canneal's line census)."""
    if workload == "blackscholes":
        text = engine_text(16, user_net="emesh_hop_counter", scheme="lax")
        batch = j_bench.blackscholes_trace(16, options_per_tile=64)
    elif workload == "canneal":
        text = j_config_text(16, shared_mem=True)
        assert text == config_text(16, shared_mem=True)
        batch = j_bench.canneal_trace(16, swaps_per_tile=16)
    else:
        text = j_config_text(16)
        batch = j_syn.ping_pong_trace(16, 20)
    jr, tr, _, _ = run_both(text, batch, census=workload == "canneal")
    assert tr.total_instructions > 0
    if workload == "canneal":
        assert int(tr.mem_counters["l2_misses"].sum()) > 0
    if workload == "ping_pong":
        assert int(tr.packets_received.sum()) == 40
