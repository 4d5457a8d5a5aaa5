"""The corners the one-launch `user_mailbox` and the window-first
`lane_commit` must get right: one JAX step against one port step.

Each case is a crafted state at T = 16 over one trace whose columns hold
the records under test (a state's `idx` picks its column).  JAX runs
`subquantum_iteration`; the port takes one step on the CPU through the
plain versions of its kernels, which the kernels equal bit for bit on
the card (`chip_smoke.py` holds them against each other on the same
families at T = 1024).  Every new-state leaf and the advanced-lane count
must be equal: zero tolerance.

A CPU test of the bound launch path closes the file: it launches
nothing, and checks that a binding validates once per set of tensors,
is replaced when any bound tensor object is (as `Simulator.warmup`
swaps the state for a clone), never matches a tensor that was freed,
keeps no tensor alive, and is the only one its kernel holds.
"""

import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.engine.step import subquantum_iteration as j_step
from graphite_tpu.trace.schema import Op, TraceBatch

from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.models.network_user import route_latency_ps
from test_torch_step import (
    assert_step_equal, config_text, make_pair, port_step,
)

T, D = 16, 3
# trace columns: one a mailbox case, then a run of follow-on records
MAILBOX_COLS = ("many_to_one", "named_recv_same_iteration",
                "any_sender_ties_same_iteration", "self_send",
                "overflow_and_pop", "all_any_sender")
L = 40
FOLLOW_FROM = len(MAILBOX_COLS)
PAYLOAD = 24


def case_batch(seed=3) -> TraceBatch:
    rng = np.random.default_rng(seed)
    op = np.full((T, L), int(Op.IALU), np.uint8)
    aux0 = np.zeros((T, L), np.int32)
    aux1 = np.full((T, L), PAYLOAD, np.int32)
    tiles = np.arange(T)
    send, recv = int(Op.SEND), int(Op.NET_RECV)
    c = {name: i for i, name in enumerate(MAILBOX_COLS)}
    # every other tile sends to tile 0, which stays at a plain op
    op[1:, c["many_to_one"]] = send
    # tile 0 names sender 5 while 1..15 send to it
    op[1:, c["named_recv_same_iteration"]] = send
    op[0, c["named_recv_same_iteration"]] = recv
    aux0[0, c["named_recv_same_iteration"]] = 5
    # tile 0 takes any sender while 1..15 send to it
    op[1:, c["any_sender_ties_same_iteration"]] = send
    op[0, c["any_sender_ties_same_iteration"]] = recv
    aux0[0, c["any_sender_ties_same_iteration"]] = -1
    # even tiles send to themselves, odd tiles receive from themselves
    col = c["self_send"]
    op[:, col] = np.where(tiles % 2 == 0, send, recv)
    aux0[:, col] = tiles
    # odd tile 2k+1 sends to 2k, which names 2k+1
    col = c["overflow_and_pop"]
    op[:, col] = np.where(tiles % 2 == 1, send, recv)
    aux0[:, col] = np.where(tiles % 2 == 1, tiles - 1, tiles + 1)
    op[:, c["all_any_sender"]] = recv
    aux0[:, c["all_any_sender"]] = -1
    # follow-on records: mostly PLAIN, with branches, fences and a few
    # records that stop a run
    pool = np.array([0, 1, 2, 3, 4, 5, 6, 7, 14, 14, 2, 2, 11, 50, 15],
                    np.uint8)
    op[:, FOLLOW_FROM:] = rng.choice(pool, size=(T, L - FOLLOW_FROM))
    aux0[:, FOLLOW_FROM:] = rng.integers(1, 9, (T, L - FOLLOW_FROM))
    z = lambda d: np.zeros((T, L), d)  # noqa: E731
    return TraceBatch(
        op=op, flags=z(np.uint8), pc=z(np.uint32), addr0=z(np.uint32),
        addr1=z(np.uint32), size0=z(np.uint8), size1=z(np.uint8),
        aux0=aux0, aux1=aux1, dyn_ps=z(np.int64), rreg0=z(np.uint16),
        rreg1=z(np.uint16), wreg=z(np.uint16))


@pytest.fixture(scope="module")
def pair():
    js, ts = make_pair(config_text(T), case_batch(), mailbox_depth=D)
    step = jax.jit(lambda st, q: j_step(js.params, js.device_trace, st, q))
    return js, ts, step


def latency_to(ts, dst: int) -> np.ndarray:
    """Every tile's zero-load latency to `dst` (the port's plain form)."""
    src = torch.arange(T, dtype=torch.int32)
    lat = route_latency_ps(ts.params.net, src,
                           torch.full((T,), dst, dtype=torch.int32),
                           torch.full((T,), PAYLOAD, dtype=torch.int32),
                           torch.tensor(True))
    return lat.numpy()


def mailbox_state(kind, seed, base, ts):
    rng = np.random.default_rng(seed)
    col = MAILBOX_COLS.index(kind)
    count = rng.integers(0, D, (T, T)).astype(np.int32)
    time_ps = (rng.integers(0, 4, (T, D, T)) * 500).astype(np.int64)
    lat_ps = rng.integers(0, 3000, (T, D, T)).astype(np.int32)
    clock = (rng.integers(0, 40, T) * 500).astype(np.int64)
    if kind == "named_recv_same_iteration":
        count[0, 5] = 0                       # the named cell is empty
    elif kind == "any_sender_ties_same_iteration":
        count[0] = rng.integers(0, 2, T)
        count[0, rng.integers(1, T, 2)] = 0   # some senders start empty
    elif kind == "overflow_and_pop":
        for k in range(0, T, 2):
            count[k, k + 1] = D               # full: this send overflows
    elif kind == "self_send":
        np.fill_diagonal(count, rng.integers(0, D + 1, T))
    head = (count + rng.integers(0, 7, (T, T))).astype(np.int32)
    if kind == "any_sender_ties_same_iteration":
        # every new send to tile 0 arrives at V, and so do some old
        # entries: the first index among them wins
        v = 40_000
        clock = (v - latency_to(ts, 0)).astype(np.int64)
        tail = (head[0] - count[0]) % D
        old = rng.random(T) < 0.5
        time_ps[0, tail, np.arange(T)] = np.where(old, v, v + 500)
    core = base.core.replace(idx=np.full(T, col, np.int32), clock_ps=clock)
    net = base.net.replace(time_ps=time_ps, lat_ps=lat_ps, head=head,
                           count=count)
    return base.replace(core=core, net=net)


def follow_state(seed, base):
    rng = np.random.default_rng(seed)
    # most windows run into the end of the row, some start mid-run
    idx = np.where(rng.random(T) < 0.7, rng.integers(L - 16, L, T),
                   rng.integers(FOLLOW_FROM, L, T)).astype(np.int32)
    core = base.core.replace(
        idx=idx,
        clock_ps=rng.integers(0, 20_000, T).astype(np.int64),
        freq_mhz=rng.choice([333, 500, 1000, 1000, 2000], T).astype(
            np.int32))
    return base.replace(core=core,
                        models_enabled=np.asarray(seed % 2 == 0))


def check_step(pair, host, qend, where):
    js, ts, step = pair
    j_next, j_adv = step(jax.device_put(host), jnp.asarray(qend, jnp.int64))
    t_next, t_adv = port_step(ts, host, qend)
    assert_step_equal(jax.device_get(j_next), int(j_adv), t_next, t_adv,
                      where)
    return t_next


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", MAILBOX_COLS)
def test_mailbox_case_matches_jax(pair, kind, seed):
    js, ts, _ = pair
    base = jax.device_get(js.state)
    host = mailbox_state(kind, seed, base, ts)
    t_next = check_step(pair, host, 2**61, f"{kind} seed {seed}")
    net = t_next["net"]
    if kind == "overflow_and_pop":
        assert bool(net["overflow"])
        for k in range(0, T, 2):              # sent, then popped
            assert int(net["count"][k, k + 1]) == D
    if kind == "named_recv_same_iteration":
        assert int(net["count"][0, 5]) == 0   # the new entry was popped


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("qend", [2**61, 24_000])
def test_follow_on_window_matches_jax(pair, qend, seed):
    js, _, _ = pair
    base = jax.device_get(js.state)
    check_step(pair, follow_state(seed, base), qend,
               f"follow-on qend {qend} seed {seed}")


# --- the bound launch path, on the CPU (no launch) -------------------------

def _mod(name):
    return importlib.import_module(f"graphite_tpu_torch.ops.{name}")


def _bound_args(name, sim, qend=torch.tensor(2**61)):
    st, ln = sim.state, sim._lanes
    if name == "user_mailbox":
        return _mod(name).bound_args(sim.params.net, ln, st.core.clock_ps,
                                     st.models_enabled, st.net)
    return _mod(name).bound_args(
        sim.device_trace.op, ln, st.core.freq_mhz, st.models_enabled,
        st.core, st.net, st.done, st.models_enabled,
        qend, sim._cost_table, 15)


def tensors_of(state, name, sim):
    """The tensors a call on `state` would bind."""
    cur = sim.state
    sim.state = state
    try:
        return _bound_args(name, sim)[0]
    finally:
        sim.state = cur


@pytest.mark.parametrize("name", ["user_mailbox", "lane_commit"])
def test_binding_validates_once_and_follows_replaced_tensors(
        name, monkeypatch):
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    sim = Simulator(SimConfig(ConfigFile.from_string(
        "[general]\ntotal_cores = 16\n[network]\nuser = emesh_hop_counter\n"
        "[clock_skew_management]\nscheme = lax\n")),
        fft_trace(16, points_per_tile=16), device="cpu")
    kernel = _mod(name).KERNEL
    packs = []
    real_pack = kernel.pack

    def counting_pack(tensors, key):
        packs.append(1)
        return real_pack(tensors, key)

    monkeypatch.setattr(kernel, "pack", counting_pack)
    monkeypatch.setattr(kernel, "binding", None)
    launches = kernel.launches

    first = kernel.bind(*_bound_args(name, sim))
    assert kernel.bind(*_bound_args(name, sim)) is first
    assert len(packs) == 1                   # validated once
    words = list(first.block)
    bound = _bound_args(name, sim)[0]
    assert words[:len(bound)] == [t.data_ptr() for t in bound]

    # warmup's swap: the state becomes a clone, then the original again
    saved = sim.state
    sim.state = saved.clone()
    clone_rings = weakref.ref(sim.state.net.time_ps)
    second = kernel.bind(*_bound_args(name, sim))
    assert second is not first and len(packs) == 2
    assert kernel.binding is second          # the only binding it holds
    assert second.holds(*_bound_args(name, sim))
    assert not second.holds(tensors_of(saved, name, sim), second.key)
    sim.state = saved
    third = kernel.bind(*_bound_args(name, sim))
    assert len(packs) == 3 and kernel.binding is third
    # the binding does not keep the replaced clone's rings alive
    gc.collect()
    assert clone_rings() is None

    # a bound tensor that is freed is never matched again
    sim.state = sim.state.clone()
    fourth = kernel.bind(*_bound_args(name, sim))
    assert len(packs) == 4
    dead = weakref.ref(sim.state.net.time_ps)
    sim.state = saved.clone()
    gc.collect()
    assert dead() is None and kernel.binding is fourth
    assert not any(r() is None for r in third.refs)
    assert any(r() is None for r in fourth.refs)
    kernel.bind(*_bound_args(name, sim))
    assert len(packs) == 5 and kernel.binding is not fourth

    # a new lane scratch, or another plain value, binds anew too
    sim._lanes = Lanes.zeros(16, "cpu")
    kernel.bind(*_bound_args(name, sim))
    assert len(packs) == 6
    if name == "lane_commit":                # run_simulation's new qend
        kernel.bind(*_bound_args(name, sim, torch.tensor(2**61)))
        assert len(packs) == 7
        packs.pop()
    tensors, key = _bound_args(name, sim)
    other = ((sim.params.net.__class__(kind="magic", freq_mhz=1000),)
             if name == "user_mailbox" else (3,))
    kernel.bind(tensors, other)
    assert len(packs) == 7 and kernel.binding.key == other
    assert kernel.launches == launches       # nothing was launched


@pytest.mark.parametrize("name", ["user_mailbox", "lane_commit"])
def test_binding_refuses_bad_arguments(name, monkeypatch):
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    sim = Simulator(SimConfig(ConfigFile.from_string(
        "[general]\ntotal_cores = 16\n")), fft_trace(16, points_per_tile=16),
        device="cpu")
    kernel = _mod(name).KERNEL
    monkeypatch.setattr(kernel, "binding", None)
    tensors, key = _bound_args(name, sim)
    bad = list(tensors)
    bad[2] = bad[2].to(torch.int64)            # wrong dtype
    with pytest.raises(TypeError, match="dtype"):
        kernel.bind(tuple(bad), key)
    bad = list(tensors)
    bad[1] = torch.zeros(17, dtype=bad[1].dtype)   # wrong shape
    with pytest.raises(ValueError, match="shape"):
        kernel.bind(tuple(bad), key)
    bad = list(tensors)
    bad[3] = torch.zeros(32, dtype=bad[3].dtype)[::2]   # strided
    with pytest.raises(ValueError, match="contiguous"):
        kernel.bind(tuple(bad), key)
    assert kernel.binding is None            # nothing half-bound
    with pytest.raises(ValueError, match="tensors on cpu"):
        kernel.launch_bound(tensors, key)


def test_warmup_frees_its_clone(monkeypatch):
    """`Simulator.warmup` runs on a clone of the state; the bindings its
    launches leave refer to the clone's tensors only weakly, so the clone
    is freed when warmup restores the state, with no call to release
    them."""
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    sim = Simulator(SimConfig(ConfigFile.from_string(
        "[general]\ntotal_cores = 16\n")), fft_trace(16, points_per_tile=16),
        device="cpu")
    saved = sim.state
    sim.state = saved.clone()
    held = weakref.ref(sim.state.net.time_ps)
    for name in ("user_mailbox", "lane_commit"):
        kernel = _mod(name).KERNEL
        monkeypatch.setattr(kernel, "binding", None)
        kernel.bind(*_bound_args(name, sim))
    sim.state = saved                # what warmup's restore does
    sim.warmup()
    gc.collect()
    assert held() is None
    for name in ("user_mailbox", "lane_commit"):
        assert _mod(name).KERNEL.binding is not None
