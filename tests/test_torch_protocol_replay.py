"""The protocol model checker's transitions replayed through the port:
graphite_tpu_torch (CPU) against graphite_tpu.

`graphite_tpu/analysis/protocol.py` `explore(protocol, 2, 1)` walks
every quiescent configuration of 2 tiles and 1 line under MSI, MOSI and
shared-L2 MESI (its tiny geometry: 1-way L1s and L2, a 2-way 8-set
directory); each
transition's action sequence (the BFS path to its configuration, then
the step) becomes the barrier-serialized trace `_replay_builders`
makes, padded with IALU records to one length as `differential` pads
it.  Every transition (24 under MSI, 32 under MOSI, 44 under shared-L2
MESI) runs through the
port on the CPU and through the JAX package's one jitted program of
that length; the final state must be equal leaf for leaf (every core,
lane, network and memory leaf the port carries: clocks, caches,
directory, mailboxes, counters).  Tolerance: zero.  Nothing in
graphite_tpu changes: the hook is this test.
"""

import functools

import jax
import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.analysis.protocol import (
    _replay_builders, explore, mc_sim_config,
)
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.engine.state import DeviceTrace
from graphite_tpu.trace.schema import Op, TraceBatch

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import state_to_arrays, trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator

from test_torch_state import _flat


def config_text(sc) -> str:
    """The model checker's SimConfig as config text, for the port."""
    return "".join(f"[{sec}]\n" + "".join(f"{k} = {v}\n"
                                          for k, v in keys.items())
                   for sec, keys in _sections(sc.cfg.as_dict()).items())


def _sections(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        sec, _, name = key.rpartition("/")
        out.setdefault(sec, {})[name] = v
    return out


def replay_batches(result):
    """One TraceBatch a transition, padded to one record count."""
    all_builders = [_replay_builders(seq, result.n_tiles)
                    for seq, _ in result.transition_seqs]
    rmax = max(len(b._op) for bs in all_builders for b in bs)
    batches = []
    for bs in all_builders:
        for b in bs:
            while len(b._op) < rmax:
                b.instr(Op.IALU)
        batches.append(TraceBatch.from_builders(bs))
    return batches


# transitions of explore(protocol, 2, 1), in BFS order
N_TRANSITIONS = {"msi": 24, "mosi": 32, "shl2_mesi": 44}


@functools.lru_cache(maxsize=None)
def replay(protocol):
    """(the JAX program, its initial state, the port's config, the
    batches) of `protocol`'s transitions, built once a module."""
    result = explore(protocol, 2, 1)
    assert not result.violations
    sc = mc_sim_config(protocol, 2)
    batches = replay_batches(result)
    fn, args = JSimulator(sc, batches[0])._auditable_fn(4096)
    tconfig = TSimConfig(TConfigFile.from_string(config_text(sc)))
    assert tconfig.cfg.get_string("caching_protocol/type", "") \
        == sc.cfg.get_string("caching_protocol/type", "")
    return jax.jit(fn), args[0], tconfig, batches


@pytest.mark.parametrize("protocol", sorted(N_TRANSITIONS))
def test_every_transition_is_replayed(protocol):
    assert len(replay(protocol)[3]) == N_TRANSITIONS[protocol]


@pytest.mark.parametrize("protocol,i", [
    (p, i) for p, n in sorted(N_TRANSITIONS.items()) for i in range(n)])
def test_transition_equal(protocol, i):
    jfn, st0, tconfig, batches = replay(protocol)
    batch = batches[i]
    out = jfn(st0, DeviceTrace.from_batch(batch))
    jstate = jax.device_get(out[0])
    assert not bool(np.asarray(out[2])), "deadlock"
    assert bool(np.asarray(jstate.done).all())
    ts = TSimulator(tconfig, trace_from_arrays(batch.__dict__),
                    device="cpu")
    ts.run()
    a, b = _flat(jstate), _flat(state_to_arrays(ts.state))
    assert set(b) <= set(a) and any(k.startswith("mem.") for k in b)
    for k in b:
        np.testing.assert_array_equal(a[k].astype(b[k].dtype), b[k],
                                      err_msg=k)
