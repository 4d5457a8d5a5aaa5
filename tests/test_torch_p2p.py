"""The lax_p2p scheme and the host-driven barrier loop against graphite_tpu.

 - the hold (`lane_fetch_cost`'s plain version under `p2p_slack_ps`)
   against the JAX step's `active` on crafted states: on an all-IALU trace
   a lane advances exactly when it is active, so one JAX step's idx delta
   is its active mask.  The states put partners on THREAD_EXIT (done only
   by this iteration's latch), hand the round counter over at its int32
   edges and leave lanes done;
 - the two-tile skew trace of `tests/test_p2p.py`, every iteration's
   clocks, idx and round counter, for 300 iterations;
 - whole runs: a 16-tile FFT and a 16-tile MSI stress run under lax_p2p,
   every SimResults field, n_quanta and last_n_iterations; the round
   counter handed over at 2**31 - 1 mid-run;
 - `barrier_host=True` with `barrier_batch` 1 and 3 through `run` and
   `run_chunk`, and the default resolution of `barrier_host` (no run).

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
from graphite_tpu.engine.step import subquantum_iteration as j_step
from graphite_tpu.tools._template import config_text as j_config_text
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import state_from_arrays, trace_from_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.engine.step import subquantum_iteration as t_step
from graphite_tpu_torch.ops import lane_fetch_cost_plain
from graphite_tpu_torch.ops.lane_fetch_cost import p2p_partner

from test_torch_engine import config_text
from test_torch_memory import run_both

QEND = 2**61
SLACK = "[clock_skew_management/lax_p2p]\nslack = {ns}\n"


def p2p_text(n, slack_ns=10, user="magic"):
    return config_text(n, user_net=user, scheme="lax_p2p",
                       extra=SLACK.format(ns=slack_ns))


def pair(text, batch, **kw):
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch, **kw)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu", **kw)
    return js, ts


def jitted_step(js):
    return jax.jit(lambda st: j_step(js.params, js.device_trace, st,
                                     jnp.asarray(QEND, jnp.int64))[0])


# --- the hold -----------------------------------------------------------

def ialu_rows(n_tiles, length):
    """Each tile: `length` IALU records, then THREAD_EXIT."""
    bs = [TraceBuilder() for _ in range(n_tiles)]
    for b in bs:
        for _ in range(length):
            b.instr(Op.IALU)
    return TraceBatch.from_builders(bs)


def crafted_state(js, rng, rnd):
    """Random clocks within a few slacks, a third of the lanes at the
    THREAD_EXIT record and the rest anywhere before it, a fifth of the
    lanes done, the round counter at `rnd`."""
    st = js.state
    T = js.params.n_tiles
    L = js.device_trace.length
    idx = np.where(rng.random(T) < 0.3, L - 1, rng.integers(0, L - 1, T))
    core = st.core.replace(
        clock_ps=jnp.asarray(rng.integers(0, 50_000, T), jnp.int64),
        idx=jnp.asarray(idx, jnp.int32))
    return st.replace(core=core,
                      done=jnp.asarray(rng.random(T) < 0.2),
                      p2p_round=jnp.asarray(rnd, jnp.int32))


def port_active(ts, host_state):
    st = state_from_arrays(host_state, "cpu")
    ln = Lanes.zeros(ts.params.n_tiles, "cpu")
    p = ts.params
    lane_fetch_cost_plain(ts.device_trace, st.core, st.done,
                          st.models_enabled, torch.tensor(QEND),
                          ts._cost_table, p.bp_enabled,
                          p.bp_mispredict_penalty, p.syscall_rt_ps, ln,
                          p.p2p_slack_ps, st.p2p_round)
    return ln.active.numpy(), st


@pytest.mark.parametrize("n_tiles", [1, 2, 16])
def test_hold_equals_jax_active(n_tiles):
    """The port's active mask under lax_p2p equals the lanes the JAX step
    advances, on 40 crafted states of each width; the states include
    lanes whose partner fetches THREAD_EXIT this very iteration (held on
    the old done flag, free on the latched one)."""
    batch = ialu_rows(n_tiles, 6)
    js, ts = pair(p2p_text(n_tiles), batch)
    step = jitted_step(js)
    rng = np.random.default_rng(n_tiles)
    rounds = [0, 1, -1, 2**31 - 1, -2**31] + list(
        rng.integers(-2**31, 2**31, 35))
    exit_partner = 0
    for rnd in rounds:
        st = crafted_state(js, rng, int(rnd))
        host = jax.device_get(st)
        active, tst = port_active(ts, host)
        j_adv = (np.asarray(jax.device_get(step(st).core.idx))
                 - np.asarray(host.core.idx)) > 0
        np.testing.assert_array_equal(active, j_adv, err_msg=f"round {rnd}")
        # lanes ahead of a partner that latches done only now
        partner = p2p_partner(tst.p2p_round, n_tiles).numpy()
        clock, idx = host.core.clock_ps, host.core.idx
        fresh_exit = (~host.done[partner]) & (idx[partner] == 6)
        ahead = clock > clock[partner] + ts.params.p2p_slack_ps
        exit_partner += int((fresh_exit & ahead & active).sum())
    if n_tiles > 1:
        assert exit_partner > 0


def test_partner_at_thread_exit_is_not_waited_for():
    """Tile 0 is far ahead of tile 1, which fetches its THREAD_EXIT this
    iteration: the latch marks tile 1 done, so tile 0 is not held — in
    both packages."""
    batch = ialu_rows(2, 3)
    js, ts = pair(p2p_text(2), batch)
    st = js.state
    st = st.replace(core=st.core.replace(
        clock_ps=jnp.asarray([10**9, 0], jnp.int64),
        idx=jnp.asarray([0, 3], jnp.int32)))
    host = jax.device_get(st)
    active, _ = port_active(ts, host)
    j_next = jax.device_get(jitted_step(js)(st))
    assert active.tolist() == [True, False]
    assert j_next.core.idx.tolist() == [1, 3]
    # with tile 1 one record earlier, tile 0 is held
    st = st.replace(core=st.core.replace(idx=jnp.asarray([0, 2], jnp.int32)))
    active, _ = port_active(ts, jax.device_get(st))
    assert active.tolist() == [False, True]


# --- trajectories and runs ----------------------------------------------

def skewed_trace(n_records=400):
    """tests/test_p2p.py:46-53: tile 0 runs 1-cycle records, tile 1
    100-cycle records."""
    b0, b1 = TraceBuilder(), TraceBuilder()
    for _ in range(n_records):
        b0.instr(Op.IALU)
        b1.instr(Op.IMUL)
    return TraceBatch.from_builders([b0, b1])


SKEW_TEXT = """
[general]
total_cores = 2
mode = lite
max_frequency = 1.0
enable_shared_mem = false
[network]
user = magic
memory = magic
[core/static_instruction_costs]
ialu = 1
imul = 100
[clock_skew_management]
scheme = lax_p2p
[clock_skew_management/lax_p2p]
slack = 100
"""


def test_skew_trajectory_equal():
    """Every iteration of the two-tile skew trace for 300 iterations:
    clocks, idx, done and the round counter equal, and the hold bounds
    the skew as `tests/test_p2p.py` requires."""
    js, ts = pair(SKEW_TEXT, skewed_trace())
    step = jitted_step(js)
    st = js.state
    qend = torch.tensor(QEND)
    held = 0
    for i in range(300):
        st = step(st)
        t_step(ts.params, ts.device_trace, ts.state, qend, ts._lanes,
               ts._cost_table)
        h = jax.device_get(st)
        where = f"iteration {i}"
        np.testing.assert_array_equal(h.core.clock_ps,
                                      ts.state.core.clock_ps.numpy(), where)
        np.testing.assert_array_equal(h.core.idx,
                                      ts.state.core.idx.numpy(), where)
        np.testing.assert_array_equal(h.done, ts.state.done.numpy(), where)
        assert int(h.p2p_round) == int(ts.state.p2p_round) == i + 1
        held += int((~ts._lanes.active & ~ts._lanes.done).sum())
    assert held > 0
    clocks = ts.state.core.clock_ps.numpy()
    assert clocks.max() - clocks.min() <= 200_000


def stress16(seed=7):
    return j_syn.memory_stress_trace(16, n_accesses=40,
                                     working_set_bytes=1 << 13,
                                     write_fraction=0.4,
                                     shared_fraction=0.5, seed=seed)


@pytest.mark.parametrize("case", ["fft16", "memstress16"])
def test_p2p_runs_equal(case):
    """Whole runs under lax_p2p at a 10 ns slack (many lanes held): every
    SimResults field, n_quanta, last_n_iterations (and the line census
    of the MSI run)."""
    if case == "fft16":
        text = p2p_text(16, user="emesh_hop_counter")
        batch = j_fft(16, points_per_tile=64)
    else:
        text = (j_config_text(16, shared_mem=True, clock_scheme="lax_p2p")
                + SLACK.format(ns=10))
        batch = stress16()
    jr, tr, js, ts = run_both(text, batch, census=case != "fft16")
    assert ts.params.n_follow(ts.device_trace.length) == 0
    assert int(ts.state.p2p_round) == ts.last_n_iterations


def test_round_counter_handed_over_at_int32_max():
    """A JAX state whose round counter is 2**31 - 1 continues in the port
    as in JAX: the counter wraps to -2**31 on the next iteration, and the
    run finishes equal."""
    text = p2p_text(16, user="emesh_hop_counter")
    batch = j_fft(16, points_per_tile=64)
    js, ts = pair(text, batch)
    js.state = js.state.replace(p2p_round=jnp.asarray(2**31 - 1, jnp.int32))
    ts.state = state_from_arrays(jax.device_get(js.state), "cpu")
    step = jitted_step(js)
    qend = torch.tensor(QEND)
    st = js.state
    for _ in range(3):
        st = step(st)
        t_step(ts.params, ts.device_trace, ts.state, qend, ts._lanes,
               ts._cost_table)
        np.testing.assert_array_equal(jax.device_get(st.core.clock_ps),
                                      ts.state.core.clock_ps.numpy())
    assert int(ts.state.p2p_round) == int(jax.device_get(st.p2p_round)) \
        == -2**31 + 2
    js.state = st
    jr, tr = js.run(), ts.run()
    for f in ("clock_ps", "instruction_count", "recv_stall_ps",
              "sync_stall_ps"):
        np.testing.assert_array_equal(getattr(jr, f), getattr(tr, f), f)
    assert js.last_n_iterations == ts.last_n_iterations
    assert int(ts.state.p2p_round) == int(jax.device_get(js.state.p2p_round))


# --- barrier_host ---------------------------------------------------------

@pytest.mark.parametrize("batch_quanta", [1, 3])
def test_barrier_host_equal(batch_quanta):
    """`barrier_host=True` with `barrier_batch` 1 and 3: a whole run, and
    run_chunk(2) to completion, each chunk's (done, quanta) and the
    iteration counts equal to the JAX package's."""
    text = config_text(16, user_net="emesh_hop_counter",
                       scheme="lax_barrier")
    batch = j_syn.message_ring_batch(16, 40, compute_per_round=200)
    kw = dict(barrier_host=True, barrier_batch=batch_quanta)
    run_both(text, batch, census=False, **kw)
    js, ts = pair(text, batch, **kw)
    assert ts.barrier_host and ts.barrier_batch == batch_quanta
    chunks = 0
    while True:
        jd, jn = js.run_chunk(2)
        td, tn = ts.run_chunk(2)
        assert (jd, jn) == (td, tn)
        assert js.last_n_iterations == ts.last_n_iterations
        chunks += 1
        if jd:
            break
    assert chunks > 2
    np.testing.assert_array_equal(jax.device_get(js.state.core.clock_ps),
                                  ts.state.core.clock_ps.numpy())


def test_barrier_host_default_resolution():
    """The default of `barrier_host`, its checks and `barrier_batch`, as the
    JAX Simulator resolves them (nothing runs): on only for lax_barrier
    with the memory subsystem at 1,024 tiles and a trace with SEND."""
    small = ("[l2_cache/T1]\ncache_size = 16\n[l1_dcache/T1]\n"
             "cache_size = 4\n[l1_icache/T1]\ncache_size = 4\n"
             "[dram_directory]\ntotal_entries = 32\nassociativity = 2\n")
    mem = j_config_text(1024, shared_mem=True) + small

    def loads(send):
        """A load on every tile, and (with `send`) one message 0 -> 1."""
        bs = [TraceBuilder() for _ in range(1024)]
        for t, b in enumerate(bs):
            b.load(t * 64)
        if send:
            bs[0].send(1, 8)
            bs[1].recv(0, 8)
        return TraceBatch.from_builders(bs)

    cases = [
        (mem, loads(True), {}),                               # on
        (mem, loads(True), {"barrier_host": False}),
        (j_config_text(1024, shared_mem=True, clock_scheme="lax") + small,
         loads(True), {}),                                    # no quanta
        (j_config_text(1024), loads(True), {}),               # no memory
        (mem, loads(False), {}),                              # no SEND
        (config_text(16, scheme="lax_barrier",
                     extra="[general]\nbarrier_batch = 5\n"),
         j_fft(16, points_per_tile=1), {"barrier_host": True}),
    ]
    got = []
    for text, batch, kw in cases:
        js, ts = pair(text, batch, **kw)
        assert (ts.barrier_host, ts.barrier_batch) == (
            js.barrier_host, js.barrier_batch)
        got.append((ts.barrier_host, ts.barrier_batch))
    assert got == [(True, 8), (False, 8), (False, 8), (False, 8),
                   (False, 8), (True, 5)]
    text = config_text(16, scheme="lax")
    tb = trace_from_arrays(j_fft(16, points_per_tile=1).__dict__)
    sc = TSimConfig(TConfigFile.from_string(text))
    with pytest.raises(ValueError, match="lax_barrier clock scheme"):
        TSimulator(sc, tb, device="cpu", barrier_host=True)
    sc = TSimConfig(TConfigFile.from_string(config_text(16)))
    with pytest.raises(ValueError, match="single-device resident"):
        TSimulator(sc, tb, device="cpu", barrier_host=True, stream=True)
    with pytest.raises(ValueError, match="barrier_batch must be >= 1"):
        TSimulator(sc, tb, device="cpu", barrier_batch=0)
