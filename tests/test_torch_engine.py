"""Whole runs: graphite_tpu_torch (on the CPU) against graphite_tpu.

Every SimResults field, `n_quanta` and `last_n_iterations` must be equal
on the trace cases of tests/test_engine.py (core timing, the branch
predictor, the USER network named and ANY_SENDER, barriers and the split
form, cond vars, mutexes, threads and join, spawn, model toggles, DVFS
set and get, the quantum loop under `lax` and `lax_barrier`), on the FFT
and message-ring programs at 16 and 64 tiles, and on a sync-heavy trace;
the error cases raise the same errors; a JAX run handed to the port
mid-run finishes equal; the 16-tile FFT agrees with the golden
interpreter.  Tolerance: zero (integer picoseconds and counts).
"""

import dataclasses

import jax
import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import DeadlockError as JDeadlock
from graphite_tpu.engine.simulator import MailboxOverflowError as JOverflow
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.golden.interpreter import run_golden
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import state_from_arrays, trace_from_arrays
from graphite_tpu_torch.engine.simulator import DeadlockError as TDeadlock
from graphite_tpu_torch.engine.simulator import (
    MailboxOverflowError as TOverflow,
)
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.engine.step import ALL_UNITS

from test_torch_memory import jax_run
from test_torch_step import sync_heavy_batch

RESULT_FIELDS = (
    "n_tiles", "completion_time_ps", "instruction_count", "clock_ps",
    "memory_stall_ps", "execution_stall_ps", "recv_instructions",
    "recv_stall_ps", "sync_instructions", "sync_stall_ps", "bp_correct",
    "bp_incorrect", "packets_sent", "packets_received",
    "total_packet_latency_ps", "n_quanta", "func_errors")


def config_text(n_tiles=4, user_net="magic", scheme="lax_barrier",
                extra=""):
    """tests/test_engine.py's make_config."""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
[network]
user = {user_net}
memory = magic
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
imul = 3
idiv = 18
falu = 3
fmul = 5
fdiv = 6
[branch_predictor]
type = one_bit
mispredict_penalty = 14
size = 1024
[clock_skew_management]
scheme = {scheme}
[clock_skew_management/lax_barrier]
quantum = 1000
[network/emesh_hop_counter]
flit_width = 64
[network/emesh_hop_counter/router]
delay = 1
[network/emesh_hop_counter/link]
delay = 1
{extra}
"""


def _batch(b):
    return b if isinstance(b, TraceBatch) else TraceBatch.from_builders(b)


def port_sim(text, batch, **kw):
    return TSimulator(TSimConfig(TConfigFile.from_string(text)),
                      trace_from_arrays(batch.__dict__), device="cpu", **kw)


def assert_results_equal(jr, tr, where=""):
    for f in RESULT_FIELDS:
        a, b = getattr(jr, f), getattr(tr, f)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{where}: {f}")
    for f in ("mem_counters", "detailed_stalls", "telemetry", "profile",
              "hist"):
        assert getattr(jr, f) is None and getattr(tr, f) is None, f
    assert jr.summary() == tr.summary()


def run_both(text, batch, **kw):
    batch = _batch(batch)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch, **kw)
    jr = jax_run(js)
    ts = port_sim(text, batch, **kw)
    tr = ts.run()
    assert_results_equal(jr, tr)
    assert js.last_n_iterations == ts.last_n_iterations
    return jr, tr, ts


# --- the trace cases of tests/test_engine.py --------------------------------

def _per_tile(n, fn):
    return [fn(t) for t in range(n)]


def _idle(n=3):
    return [TraceBuilder().instr(Op.IALU) for _ in range(n)]


def c_static_costs():
    def b(t):
        x = TraceBuilder()
        for _ in range(10):
            x.instr(Op.IALU)
        for _ in range(2):
            x.instr(Op.IMUL)
        return x
    return {}, _per_tile(4, b)


def c_all_cost_classes():
    x = TraceBuilder()
    for op in (Op.GENERIC, Op.MOV, Op.IALU, Op.IMUL, Op.IDIV, Op.FALU,
               Op.FMUL, Op.FDIV, Op.XMM_SS, Op.LFENCE, Op.MFENCE):
        x.instr(op)
    return {}, [x] + _idle()


def c_dynamic_and_spawn():
    x = TraceBuilder().dynamic(Op.STALL, 12345)
    for _ in range(3):
        x.instr(Op.IALU)
    x.dynamic(Op.SPAWN, 25_000).instr(Op.IALU)
    y = TraceBuilder().instr(Op.IALU).dynamic(Op.SPAWN, 10).instr(Op.IALU)
    return {}, [x, y] + _idle(2)


def c_core_frequency():
    extra = ('[general]\nmax_frequency = 2.0\n[dvfs]\ndomains = "<2.0, '
             'CORE, L1_ICACHE, L1_DCACHE, L2_CACHE, DIRECTORY, '
             'NETWORK_USER, NETWORK_MEMORY>"\n')
    return {"extra": extra}, [TraceBuilder().instr(Op.IALU)
                              for _ in range(4)]


def c_branch_predictor():
    x = TraceBuilder()
    for _ in range(5):
        x.branch(True, pc=0x100)
    y = TraceBuilder()
    for i in range(6):
        y.branch(i % 2 == 0, pc=0x40)
    z = TraceBuilder().branch(True, pc=0xFFFFFFFF).branch(True, pc=0x3FF)
    return {}, [x, y, z] + _idle(1)


def c_ping_pong():
    return {"n_tiles": 2}, j_syn.ping_pong_trace(2, n_rounds=3)


def c_no_wait_recv():
    b1 = TraceBuilder()
    for _ in range(10):
        b1.instr(Op.IALU)
    b1.recv(0)
    return {"n_tiles": 2}, [TraceBuilder().send(1, 8), b1]


def c_emesh_latency():
    return ({"user_net": "emesh_hop_counter"},
            [TraceBuilder().send(3, 8).send(2, 100), TraceBuilder(),
             TraceBuilder().recv(0, 100), TraceBuilder().recv(0)])


def c_recv_any_earliest():
    b2 = TraceBuilder()
    for _ in range(5):
        b2.instr(Op.IALU)
    b2.send(0, 8)
    return {}, [TraceBuilder().recv(-1).recv(-1),
                TraceBuilder().send(0, 8), b2, TraceBuilder()]


def c_recv_any_ties():
    # tiles 1-3 send to 0 at the same time: ANY_SENDER takes the lowest
    # sender first (jnp.argmin's first index on ties)
    b0 = TraceBuilder().recv(-1, 8).recv(-1, 16).recv(-1, 24)
    return {}, [b0] + [TraceBuilder().send(0, 8 * t) for t in (1, 2, 3)]


def c_mailbox_in_order():
    b0, b1 = TraceBuilder(), TraceBuilder()
    for _ in range(5):
        b0.send(1, 8)
        b1.recv(0)
    return {"n_tiles": 2}, [b0, b1]


def c_int32_latency_wrap():
    # a 20 MB packet's latency exceeds int32 picoseconds: the [T, D, T]
    # latency ring is int32 and wraps (step.py:448) in both packages
    return ({"n_tiles": 4, "user_net": "emesh_hop_counter"},
            [TraceBuilder().send(3, 20_000_000), TraceBuilder(),
             TraceBuilder(), TraceBuilder().recv(0, 20_000_000)])


def c_barrier_max_time():
    def b(t):
        x = TraceBuilder()
        if t == 0:
            x.barrier_init(0, 4)
        for _ in range((t + 1) * 2):
            x.instr(Op.IALU)
        return x.barrier_wait(0).instr(Op.IALU)
    return {}, _per_tile(4, b)


def c_barrier_reusable_and_init_race():
    def b(t):
        # every tile initializes barrier 0 at once with its own count:
        # the lowest tile's count (2) wins the election
        x = TraceBuilder().barrier_init(0, 2 + t).instr(Op.IALU)
        x.barrier_wait(0)
        for _ in range(t + 1):
            x.instr(Op.IALU)
        return x.barrier_wait(0)
    return {"n_tiles": 2}, _per_tile(2, b)


def c_split_barrier():
    def b(t):
        x = TraceBuilder()
        if t == 0:
            x.barrier_init(1, 4)
        for _ in range(t * 3):
            x.instr(Op.IALU)
        x.barrier_arrive(1)
        for _ in range(2):
            x.instr(Op.IMUL)
        x.barrier_sync(1, 1).barrier_arrive(1).barrier_sync(1, 2)
        return x
    return {}, _per_tile(4, b)


def c_mutex_contention():
    b0 = TraceBuilder().mutex_init(0).mutex_lock(0)
    for _ in range(10):
        b0.instr(Op.IALU)
    b0.mutex_unlock(0)
    b1 = TraceBuilder().instr(Op.IALU).mutex_lock(0).instr(Op.IALU)
    b1.mutex_unlock(0)
    return {}, [b0, b1, TraceBuilder(), TraceBuilder()]


def c_mutex_grant_order():
    b0 = TraceBuilder().mutex_init(0).mutex_lock(0)
    for _ in range(4):
        b0.instr(Op.IALU)
    b0.mutex_unlock(0)
    b1 = TraceBuilder().instr(Op.IALU).mutex_lock(0)
    b1.instr(Op.IALU).mutex_unlock(0)
    b2 = TraceBuilder().instr(Op.IALU).instr(Op.IALU).mutex_lock(0)
    b2.instr(Op.IALU).mutex_unlock(0)
    return {}, [b0, b1, b2, TraceBuilder()]


def c_cond_producer_consumer():
    b1 = TraceBuilder().mutex_init(0).cond_init(0).mutex_lock(0)
    b1.cond_wait(0, 0).instr(Op.IALU).mutex_unlock(0)
    b0 = TraceBuilder()
    for _ in range(3):
        b0.instr(Op.IALU)
    b0.mutex_lock(0)
    for _ in range(2):
        b0.instr(Op.IALU)
    b0.cond_signal(0).mutex_unlock(0)
    return {"n_tiles": 2}, [b0, b1]


def c_cond_broadcast_relock():
    waiters = []
    for t in range(3):
        b = TraceBuilder()
        if t == 0:
            b.mutex_init(0).cond_init(0)
        b.mutex_lock(0).cond_wait(0, 0).instr(Op.IALU).mutex_unlock(0)
        waiters.append(b)
    b0 = TraceBuilder()
    for _ in range(5):
        b0.instr(Op.IALU)
    b0.mutex_lock(0).cond_broadcast(0).mutex_unlock(0)
    return {}, [b0] + waiters


def c_cond_poster_pinned_join():
    b0 = TraceBuilder().mutex_init(0).cond_init(0)
    for _ in range(5):
        b0.instr(Op.IALU)
    b0.mutex_lock(0).cond_broadcast(0).mutex_unlock(0).thread_join(1)
    b1 = TraceBuilder().mutex_lock(0).cond_wait(0, 0).mutex_unlock(0)
    return {"n_tiles": 2}, [b0, b1]


def c_cond_broadcast_before_signal():
    b2 = TraceBuilder().dynamic(Op.STALL, 20_000)
    w = TraceBuilder().instr(Op.IALU).mutex_lock(0).cond_wait(0, 0)
    w.mutex_unlock(0)
    b0 = TraceBuilder().mutex_init(0).cond_init(0)
    for _ in range(3):
        b0.instr(Op.IALU)
    b0.cond_broadcast(0)
    for _ in range(2):
        b0.instr(Op.IALU)
    b0.cond_signal(0)
    return {}, [b0, w, b2, TraceBuilder()]


def c_cond_fifo_signals():
    w1 = TraceBuilder().instr(Op.IALU).mutex_lock(0)
    w1.cond_wait(0, 0).mutex_unlock(0)
    w2 = TraceBuilder().instr(Op.IALU).instr(Op.IALU).mutex_lock(0)
    w2.cond_wait(0, 0).mutex_unlock(0)
    b0 = TraceBuilder().mutex_init(0).cond_init(0)
    for _ in range(5):
        b0.instr(Op.IALU)
    b0.cond_signal(0)
    for _ in range(2):
        b0.instr(Op.IALU)
    b0.cond_signal(0)
    return {}, [b0, w1, w2, TraceBuilder()]


def c_published_cond_join():
    b0 = TraceBuilder()
    for _ in range(4):
        b0.instr(Op.IALU)
    b0.cond_signal(2, publish=True).instr(Op.IALU)
    b0.cond_broadcast(2, publish=True)
    b1 = TraceBuilder().cond_join(2, 1).instr(Op.IALU).cond_join(2, 2)
    b2 = TraceBuilder().instr(Op.IDIV).cond_join(2, 2)
    return {}, [b0, b1, b2, TraceBuilder()]


def c_join():
    b0 = TraceBuilder().thread_spawn(1).thread_join(1).instr(Op.IALU)
    b1 = TraceBuilder()
    for _ in range(7):
        b1.instr(Op.IALU)
    return {"n_tiles": 2}, [b0, b1]


def c_models_toggle():
    b = TraceBuilder()
    b._append(Op.DISABLE_MODELS)
    for _ in range(5):
        b.instr(Op.IALU)
    b.send(1, 8)._append(Op.ENABLE_MODELS)
    for _ in range(3):
        b.instr(Op.IMUL)
    c = TraceBuilder().recv(0).instr(Op.IALU).branch(True, pc=4)
    return {}, [b, c, TraceBuilder(), TraceBuilder()]


def c_models_start_disabled():
    extra = "[general]\ntrigger_models_within_application = true\n"
    b = TraceBuilder().instr(Op.IALU).bblock(10, 10)._append(
        Op.ENABLE_MODELS)
    for _ in range(20):
        b.instr(Op.IALU)
    return {"extra": extra}, [b] + _idle()


def c_dvfs_set_get():
    b = TraceBuilder().instr(Op.IALU).dvfs_set(0, 500).instr(Op.IALU)
    b.dvfs_set(0, 2000).instr(Op.IALU)              # above max: rejected
    b.dvfs_set(0, 250, hold=True).instr(Op.IALU)
    b._append(Op.DVFS_GET, aux0=0).syscall(2, 10).instr(Op.IALU)
    c = TraceBuilder().dvfs_set(1, 300).dvfs_set(5, 300).instr(Op.IALU)
    return {}, [b, c] + _idle(2)


def c_lax_barrier_many_quanta():
    b = TraceBuilder()
    for _ in range(400):
        b.instr(Op.IDIV)
    return {}, [b] + _idle()


def c_lax_single_quantum():
    b = TraceBuilder()
    for _ in range(100):
        b.instr(Op.IDIV)
    return {"scheme": "lax"}, [b] + _idle()


def c_long_stall_fast_forward():
    b = TraceBuilder().dynamic(Op.STALL, 5_000_000_000).instr(Op.IALU)
    return {}, [b] + _idle()


def c_late_sender():
    b0 = TraceBuilder().dynamic(Op.STALL, 5_000_000).send(1, 8)
    return {"n_tiles": 2}, [b0, TraceBuilder().recv(0)]


def c_cross_quantum_messaging():
    b0 = TraceBuilder()
    for _ in range(1500):
        b0.instr(Op.IALU)
    b0.send(1, 8)
    return {"n_tiles": 2}, [b0, TraceBuilder().recv(0)]


CASES = {name[2:]: fn for name, fn in sorted(globals().items())
         if name.startswith("c_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_case_equal(case):
    kw, builders = CASES[case]()
    text = config_text(**kw)
    run_both(text, builders)


# --- trace programs -----------------------------------------------------

BENCH = dict(user_net="emesh_hop_counter")


@pytest.mark.parametrize("n_tiles", [16, 64])
@pytest.mark.parametrize("scheme", ["lax", "lax_barrier"])
def test_fft_equal(n_tiles, scheme):
    run_both(config_text(n_tiles, scheme=scheme, **BENCH),
             j_fft(n_tiles, points_per_tile=32 if n_tiles == 64 else 64),
             inner_block=64 if scheme == "lax" else 16)


@pytest.mark.parametrize("n_tiles", [16, 64])
def test_message_ring_equal(n_tiles):
    run_both(config_text(n_tiles, scheme="lax", **BENCH),
             j_syn.message_ring_batch(n_tiles, 6, compute_per_round=21,
                                      pattern="uniform_random"),
             mailbox_depth=8)


@pytest.mark.parametrize("pattern", ["transpose", "tornado"])
def test_network_traffic_equal(pattern):
    run_both(config_text(16, scheme="lax", **BENCH),
             j_syn.network_traffic_trace(16, pattern, total_packets=6,
                                         offered_load=0.5),
             mailbox_depth=32)


def test_compute_mix_equal():
    run_both(config_text(4, scheme="lax_barrier"),
             j_syn.compute_mix_trace(4, n_instructions=300, seed=3))


@pytest.mark.parametrize("scheme", ["lax", "lax_barrier"])
def test_sync_heavy_equal(scheme):
    run_both(config_text(16, scheme=scheme, **BENCH), sync_heavy_batch(16),
             inner_block=8)


def test_fft16_agrees_with_golden_interpreter():
    text = config_text(16, scheme="lax", **BENCH)
    batch = j_fft(16, points_per_tile=64)
    g = run_golden(JSimConfig(JConfigFile.from_string(text)), batch)
    tr = port_sim(text, batch).run()
    np.testing.assert_array_equal(g.clock_ps, tr.clock_ps)
    # the engines fold charged recv/sync waits into instruction_count
    # (tests/test_golden.py convention)
    np.testing.assert_array_equal(
        g.instruction_count + g.recv_instructions + g.sync_instructions,
        tr.instruction_count)
    np.testing.assert_array_equal(g.recv_instructions, tr.recv_instructions)
    np.testing.assert_array_equal(g.sync_instructions, tr.sync_instructions)
    np.testing.assert_array_equal(g.bp_correct, tr.bp_correct)


# --- errors ---------------------------------------------------------------

def _raises_both(text, builders, jexc, texc, **kw):
    batch = _batch(builders)
    with pytest.raises(jexc):
        JSimulator(JSimConfig(JConfigFile.from_string(text)), batch,
                   **kw).run()
    with pytest.raises(texc):
        port_sim(text, batch, **kw).run()


def test_deadlock_errors_equal():
    _raises_both(config_text(), [TraceBuilder().recv(1)] + _idle(),
                 JDeadlock, TDeadlock)
    b0 = TraceBuilder().cond_init(0).mutex_init(0).cond_signal(0)
    b1 = TraceBuilder().instr(Op.IALU).mutex_lock(0).cond_wait(0, 0)
    _raises_both(config_text(n_tiles=2), [b0, b1], JDeadlock, TDeadlock)


def test_mailbox_overflow_errors_equal():
    # tile 1 blocks on a late message from tile 2 while tile 0 fills the
    # depth-2 (0 -> 1) ring
    b0, b1, b2 = TraceBuilder(), TraceBuilder(), TraceBuilder()
    for _ in range(5):
        b0.send(1, 8)
    b1.recv(2)
    for _ in range(5):
        b1.recv(0)
    for _ in range(8):
        b2.dynamic(Op.STALL, 10)
    b2.send(1, 8)
    _raises_both(config_text(n_tiles=4, scheme="lax"),
                 [b0, b1, b2, TraceBuilder()], JOverflow, TOverflow,
                 mailbox_depth=2)


# --- handoff and gating ----------------------------------------------------

def test_mid_run_handoff_from_jax():
    """JAX runs a few lax_barrier quanta; the port takes its state and
    finishes; the result equals the JAX package finishing the same state
    (and the whole JAX run in every field but the quantum count)."""
    text = config_text(16, scheme="lax_barrier", **BENCH)
    batch = j_fft(16, points_per_tile=64)
    whole = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    whole_r = whole.run()
    chunk = whole_r.n_quanta // 2
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    done, nq = js.run_chunk(chunk)
    assert not done and nq == chunk > 0
    ts = port_sim(text, batch)
    ts.state = state_from_arrays(jax.device_get(js.state), "cpu")
    tr = ts.run()
    jr = js.run()
    assert_results_equal(jr, tr)
    assert js.last_n_iterations == ts.last_n_iterations
    for f in RESULT_FIELDS:
        if f != "n_quanta":
            np.testing.assert_array_equal(np.asarray(getattr(whole_r, f)),
                                          np.asarray(getattr(tr, f)))


@pytest.mark.parametrize("program", ["fft", "ring", "sync"])
def test_unit_gating_is_bit_exact(program):
    """Skipping the units whose ops never occur changes nothing: the same
    trace with every unit forced on gives the same result."""
    text = config_text(16, scheme="lax", **BENCH)
    batch = {"fft": lambda: j_fft(16, points_per_tile=32),
             "ring": lambda: j_syn.message_ring_batch(16, 5),
             "sync": lambda: sync_heavy_batch(16, seed=1)}[program]()
    gated = port_sim(text, batch)
    ungated = port_sim(text, batch)
    ungated.params = dataclasses.replace(ungated.params, units=ALL_UNITS)
    if program != "sync":
        assert gated.params.units < ALL_UNITS
    rg, ru = gated.run(), ungated.run()
    assert_results_equal(rg, ru)
    assert gated.last_n_iterations == ungated.last_n_iterations


def test_run_chunk_matches_jax():
    text = config_text(16, scheme="lax_barrier", **BENCH)
    batch = j_fft(16, points_per_tile=32)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    ts = port_sim(text, batch)
    assert js.run_chunk(2) == ts.run_chunk(2)
    assert js.last_n_iterations == ts.last_n_iterations
    np.testing.assert_array_equal(np.asarray(js.state.core.clock_ps),
                                  ts.state.core.clock_ps.numpy())
