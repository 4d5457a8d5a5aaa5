"""graphite_tpu_torch state tensors against graphite_tpu's pytrees, and the
numpy conversions that hand a JAX run to the port."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.engine.state import init_state as j_init_state
from graphite_tpu.engine.step import subquantum_iteration as j_step
from graphite_tpu.trace.benchmarks import fft_trace as j_fft

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import (
    state_from_arrays, state_to_arrays, trace_from_arrays,
)
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.engine.state import DeviceTrace
from graphite_tpu_torch.engine.state import init_state as t_init_state
import torch_threads  # noqa: F401  (one intra-op thread)


CONFIG = """
[general]
total_cores = 16
mode = lite
[network]
user = emesh_hop_counter
[core/static_instruction_costs]
ialu = 1
[clock_skew_management]
scheme = lax
"""


def _flat(tree, prefix=""):
    """{path: ndarray} over a JAX pytree dataclass, a port dataclass or the
    nested dict `state_to_arrays` returns; None leaves are skipped."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        arr = tree.numpy() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        return {prefix: arr}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def assert_tree_equal(jax_tree, port_tree):
    a, b = _flat(jax.device_get(jax_tree)), _flat(port_tree)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(n_tiles=4, core_freq_mhz=1000),
    dict(n_tiles=16, core_freq_mhz=750, bp_size=64, mailbox_depth=3,
         n_barriers=8, n_mutexes=5, n_conds=7, n_pending_signals=2,
         models_enabled=False),
])
def test_init_state_leaf_equal(kw):
    assert_tree_equal(j_init_state(**kw), t_init_state(**kw, device="cpu"))


def test_simulator_initial_state_equal():
    batch = j_fft(16, points_per_tile=16)
    js = JSimulator(JSimConfig(JConfigFile.from_string(CONFIG)), batch)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(CONFIG)),
                    trace_from_arrays(batch.__dict__), device="cpu")
    assert_tree_equal(js.state, ts.state)
    assert js.params.mailbox_depth == ts.params.mailbox_depth


def test_device_trace_zero_extends_pc():
    batch = j_fft(16, points_per_tile=16)
    batch.pc[3, 2] = np.uint32(0xFFFFFFF0)
    tb = trace_from_arrays(batch.__dict__)
    dt = DeviceTrace.from_batch(tb, "cpu")
    assert dt.pc.dtype == torch.int64
    assert int(dt.pc[3, 2]) == 0xFFFFFFF0
    for name in ("op", "flags", "aux0", "aux1", "dyn_ps"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                      getattr(batch, name))


def test_trace_from_arrays_round_trip():
    batch = j_fft(16, points_per_tile=16)
    tb = trace_from_arrays({k: np.asarray(v)
                            for k, v in batch.__dict__.items()})
    for f in dataclasses.fields(tb):
        a, b = getattr(batch, f.name), getattr(tb, f.name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        trace_from_arrays({"op": batch.op})


def test_state_round_trip_mid_run():
    """A JAX state a few iterations in converts to the port and back to
    the same leaves."""
    batch = j_fft(16, points_per_tile=16)
    js = JSimulator(JSimConfig(JConfigFile.from_string(CONFIG)), batch)
    step = jax.jit(lambda st: j_step(js.params, js.device_trace, st,
                                     jax.numpy.asarray(2**61))[0])
    st = js.state
    for _ in range(5):
        st = step(st)
    host = jax.device_get(st)
    port = state_from_arrays(host, "cpu")
    assert_tree_equal(host, port)
    back = state_to_arrays(port)
    assert_tree_equal(host, back)
    again = state_from_arrays(back, "cpu")
    assert_tree_equal(host, again)


def test_state_from_arrays_refuses_unported_subsystems():
    # the iocoom and memory states are ported (the memory slice), and so
    # is the USER NoC's (the contention-NoC slice); the histograms are not
    host = jax.device_get(j_init_state(4, core_freq_mhz=1000))
    host = host.replace(hist={"x": np.zeros(4)})
    with pytest.raises(NotImplementedError, match="item 12"):
        state_from_arrays(host, "cpu")
