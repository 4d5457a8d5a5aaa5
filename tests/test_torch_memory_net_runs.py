"""The MEMORY net under emesh_hop_by_hop and atac, the coherence stress
run: graphite_tpu_torch (CPU) against graphite_tpu.

tests/test_memory_net.py's 16-tile stress workload under lax_barrier:
a JAX run stopped after three quanta is handed to the port
(`convert.state_from_arrays`, the MEMORY net's queues `MemState.noc`
included) and finishes equal to the JAX run (every SimResults field, the
summary, `last_n_iterations`, `MemState.noc`); the port's own first
three quanta leave the state the JAX run had; hop-by-hop finishes later
than the zero-load hop counter on the same trace.  Zero tolerance.
"""

import jax
import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.trace import synthetic as j_syn

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import state_from_arrays, trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator

from test_torch_memory import assert_results_equal, mem_text
from test_torch_memory_net import NETS, assert_noc_equal, net_text
from test_torch_state import _flat

QUANTUM = "[clock_skew_management/lax_barrier]\nquantum = 100\n"


def port(text, batch):
    return TSimulator(TSimConfig(TConfigFile.from_string(text)),
                      trace_from_arrays(batch.__dict__), device="cpu")


@pytest.mark.parametrize("net", NETS)
def test_stress_run_handed_over_mid_run(net):
    """Requests, evictions, INV / FLUSH / WB fan-outs and acks through
    the contention net, handed over after three of ~80 quanta."""
    text = net_text(16, net, extra=QUANTUM)
    batch = j_syn.memory_stress_trace(16, n_accesses=40,
                                      working_set_bytes=1 << 13,
                                      write_fraction=0.4,
                                      shared_fraction=0.5, seed=3)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    all_done, _ = js.run_chunk(3)
    assert not all_done
    mid = jax.device_get(js.state)
    assert mid.mem.noc is not None
    jr = js.run()
    # the port's own first three quanta reach the JAX state, leaf for leaf
    # (the port has no `live` / `phase_skips`), noc included
    ts = port(text, batch)
    assert ts.run_chunk(3) == (False, 3)
    a, b = _flat(mid.mem), _flat(ts.state.mem)
    assert set(b) <= set(a) and any(k.startswith("noc.") for k in b)
    for k in b:
        np.testing.assert_array_equal(a[k].astype(b[k].dtype), b[k],
                                      err_msg=k)
    # the JAX state, handed over, finishes as the JAX run did
    ts = port(text, batch)
    ts.state = state_from_arrays(mid, "cpu")
    tr = ts.run()
    assert_results_equal(jr, tr)
    assert js.last_n_iterations == ts.last_n_iterations
    assert_noc_equal(js, ts)
    assert int(tr.mem_counters["invalidations"].sum()) > 0
    if net == NETS[0]:
        zero = port(mem_text(16, net="emesh_hop_counter", extra=QUANTUM),
                    batch)
        assert tr.completion_time_ps > zero.run().completion_time_ps
