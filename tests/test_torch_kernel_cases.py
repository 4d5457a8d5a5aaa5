"""The corners the kernels must get right: one JAX step against one
port step.

Each case is a crafted state at T = 16 over one trace whose columns hold
the records under test (a state's `idx` picks its column): the one-
launch `user_mailbox`'s sends and receives, the window-first
`lane_commit`'s follow-on runs, `barrier_sync`'s racing inits with
negative counts, a full release and a split barrier across the
generation ring's wrap, and a run under a predictor whose size is not a
power of two (`lane_fetch_cost`'s remainder, not its mask).  JAX runs
`subquantum_iteration`; the port takes one step on the CPU through the
plain versions of its kernels, which the kernels equal bit for bit on
the card (`chip_smoke.py` holds them against each other on the same
families at T = 1024).  Every new-state leaf and the advanced-lane count
must be equal: zero tolerance.

CPU tests of the bound launch path close the file, for all four
kernels: they launch nothing, and check that a binding validates once
per set of tensors, is replaced when any bound tensor object is (as
`Simulator.warmup` swaps the state for a clone), never matches a tensor
that was freed, keeps no tensor alive, and is the only one its kernel
holds; and that the argument blocks hold what the kernels read.
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
    assert_step_equal, config_text, jax_trajectory, make_pair, port_step,
    sync_heavy_batch,
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


# --- barrier_sync's corners: racing inits, a full release, a ring wrap ---

NB = 4
BARRIER_COLS = ("init_race", "full_release", "sync_ring_wrap")


def barrier_batch() -> TraceBatch:
    """One column a barrier case (a state's `idx` picks its column)."""
    BL = len(BARRIER_COLS)
    op = np.full((T, BL), int(Op.IALU), np.uint8)
    aux0 = np.zeros((T, BL), np.int32)
    aux1 = np.zeros((T, BL), np.int32)
    tiles = np.arange(T)
    c = {name: i for i, name in enumerate(BARRIER_COLS)}
    # every tile inits barrier t mod 3 with its own count, some negative;
    # tile 15 waits at barrier 3 instead
    col = c["init_race"]
    op[:, col] = int(Op.BARRIER_INIT)
    aux0[:, col] = tiles % 3
    aux1[:, col] = (tiles * 7) % 23 - 15
    op[15, col] = int(Op.BARRIER_WAIT)
    aux0[15, col] = 3
    # tiles 0-11 wait at barrier 1, tiles 12-15 arrive there (split form)
    col = c["full_release"]
    op[:, col] = np.where(tiles < 12, int(Op.BARRIER_WAIT),
                          int(Op.BARRIER_ARRIVE))
    aux0[:, col] = 1
    # tiles 0-1 arrive at barrier 2, the rest sync on generations of it
    # on both sides of the ring's wrap (aux1 - 8, aux1, negative ones)
    col = c["sync_ring_wrap"]
    op[:, col] = np.where(tiles < 2, int(Op.BARRIER_ARRIVE),
                          int(Op.BARRIER_SYNC))
    aux0[:, col] = 2
    aux1[:, col] = np.array([0, 0, 16, 8, 0, 15, 17, 9, -1, -8, -9, 7, 24,
                             16, 1, 23])
    z = lambda d: np.zeros((T, BL), d)  # noqa: E731
    return TraceBatch(
        op=op, flags=z(np.uint8), pc=z(np.uint32), addr0=z(np.uint32),
        addr1=z(np.uint32), size0=z(np.uint8), size1=z(np.uint8),
        aux0=aux0, aux1=aux1, dyn_ps=z(np.int64), rreg0=z(np.uint16),
        rreg1=z(np.uint16), wreg=z(np.uint16))


@pytest.fixture(scope="module")
def barrier_pair():
    js, ts = make_pair(config_text(T), barrier_batch(), mailbox_depth=D,
                       n_barriers=NB)
    step = jax.jit(lambda st, q: j_step(js.params, js.device_trace, st, q))
    return js, ts, step


def barrier_state(kind, seed, base):
    """A state at `kind`'s column whose barrier tables hold non-zero
    counts, arrivals, times and generations everywhere."""
    rng = np.random.default_rng(seed)
    col = BARRIER_COLS.index(kind)
    count = rng.integers(20, 40, NB).astype(np.int32)   # no stale release
    arrived = rng.integers(0, 20, NB).astype(np.int32)
    waiting = rng.random(T) < 0.2
    gen = rng.integers(0, 30, NB).astype(np.int32)
    done = rng.random(T) < 0.1
    if kind == "full_release":
        # tiles 0-5 already wait; the other ten arrive now and release
        waiting = np.arange(T) < 6
        count[1], arrived[1] = T, 6
        done[:] = False
        done[3] = rng.random() < 0.5      # a done waiter is no participant
    elif kind == "sync_ring_wrap":
        # the two arrivals release barrier 2 into generation 16 = slot 0
        count[2], arrived[2], gen[2] = 4, 2, 15
        done[:2] = False
    sync = base.sync.replace(
        barrier_count=count, barrier_arrived=arrived,
        barrier_time_ps=rng.integers(1, 60_000, NB).astype(np.int64),
        barrier_waiting=waiting, barrier_gen=gen,
        barrier_release_ps=rng.integers(1, 60_000, (NB, 8)).astype(
            np.int64))
    core = base.core.replace(
        idx=np.full(T, col, np.int32),
        clock_ps=rng.integers(0, 80_000, T).astype(np.int64))
    return base.replace(core=core, sync=sync, done=done)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", BARRIER_COLS)
def test_barrier_case_matches_jax(barrier_pair, kind, seed):
    js, _, _ = barrier_pair
    base = jax.device_get(js.state)
    host = barrier_state(kind, seed, base)
    t_next = check_step(barrier_pair, host, 2**61, f"{kind} seed {seed}")
    sync = t_next["sync"]
    if kind == "init_race":
        # the lowest live initialising tile's count wins, negative or not
        for b in range(3):
            t = min(t for t in range(b, 15, 3) if not host.done[t])
            assert int(sync["barrier_count"][b]) == (t * 7) % 23 - 15
    elif kind == "full_release":
        assert int(sync["barrier_arrived"][1]) == 0
        assert int(sync["barrier_gen"][1]) == int(host.sync.barrier_gen[1]) + 1
    else:
        assert int(sync["barrier_gen"][2]) == 16


@pytest.mark.parametrize("bp_size", [1000, 48])
def test_step_matches_jax_with_bp_size_not_a_power_of_two(bp_size):
    """Along a run whose branches sit at high pcs, under a predictor of
    `bp_size` entries: pc mod bp_size is a remainder, not a mask."""
    text = config_text(T).replace("size = 64", f"size = {bp_size}")
    batch = sync_heavy_batch(T, seed=1)
    js, ts = make_pair(text, batch)
    assert ts.params.bp_size == bp_size == js.params.bp_size
    probes = (0, 1, 2, 4, 6, 9, 13, 20, 30)
    hosts, advs = jax_trajectory(js, 2**61, max(probes) + 1)
    for k in probes:
        t_next, t_adv = port_step(ts, hosts[k], 2**61)
        assert_step_equal(hosts[k + 1], advs[k], t_next, t_adv,
                          f"bp_size {bp_size} step {k}")
    assert int(hosts[-1].core.bp_correct.sum()
               + hosts[-1].core.bp_incorrect.sum()) > 0


# --- the bound launch path, on the CPU (no launch) -------------------------

def _mod(name):
    return importlib.import_module(f"graphite_tpu_torch.ops.{name}")


KERNEL_NAMES = ["lane_fetch_cost", "user_mailbox", "barrier_sync",
                "lane_commit"]


def _bound_args(name, sim, qend=torch.tensor(2**61)):
    st, ln = sim.state, sim._lanes
    if name == "lane_fetch_cost":
        return _mod(name).bound_args(
            sim.device_trace, st.core, st.done, st.models_enabled, qend,
            sim._cost_table, True, 14, 2000, ln)
    if name == "user_mailbox":
        return _mod(name).bound_args(sim.params.net, ln, st.core.clock_ps,
                                     st.models_enabled, st.net)
    if name == "barrier_sync":
        return _mod(name).bound_args(ln, st.core.clock_ps, st.sync)
    return _mod(name).bound_args(
        sim.device_trace.op, ln, st.core.freq_mhz, st.models_enabled,
        st.core, st.net, st.done, st.models_enabled,
        qend, sim._cost_table, 15)


def watched(name, state):
    """A state tensor that `name`'s call binds."""
    return {"lane_fetch_cost": state.core.idx,
            "user_mailbox": state.net.time_ps,
            "barrier_sync": state.sync.barrier_release_ps,
            "lane_commit": state.core.clock_ps}[name]


def other_key(name, sim):
    """Another set of the kernel's plain values (None: it has none)."""
    return {"lane_fetch_cost": (False, 3, 1000),
            "user_mailbox": (sim.params.net.__class__(kind="magic",
                                                      freq_mhz=1000),),
            "barrier_sync": None,
            "lane_commit": (3,)}[name]


def tensors_of(state, name, sim):
    """The tensors a call on `state` would bind."""
    cur = sim.state
    sim.state = state
    try:
        return _bound_args(name, sim)[0]
    finally:
        sim.state = cur


@pytest.mark.parametrize("name", KERNEL_NAMES)
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
    monkeypatch.setattr(kernel, "packs", 0)
    launches = kernel.launches

    first = kernel.bind(*_bound_args(name, sim))
    assert kernel.bind(*_bound_args(name, sim)) is first
    assert len(packs) == 1 == kernel.packs   # validated once
    words = list(first.block)
    bound = _bound_args(name, sim)[0]
    # an optional argument left out (None) packs a null pointer
    assert words[:len(bound)] == [0 if t is None else t.data_ptr()
                                  for t in bound]

    # warmup's swap: the state becomes a clone, then the original again
    saved = sim.state
    sim.state = saved.clone()
    clone_rings = weakref.ref(watched(name, sim.state))
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
    dead = weakref.ref(watched(name, sim.state))
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
    if name in ("lane_fetch_cost", "lane_commit"):   # a run's new qend
        kernel.bind(*_bound_args(name, sim, torch.tensor(2**61)))
        assert len(packs) == 7
        packs.pop()
    tensors, key = _bound_args(name, sim)
    other = other_key(name, sim)
    if other is None:                        # no plain values to change
        assert key == ()
        with pytest.raises(ValueError, match="unexpected key"):
            kernel.bind(tensors, (3,))
    else:
        kernel.bind(tensors, other)
        assert len(packs) == 7 and kernel.binding.key == other
    assert kernel.launches == launches       # nothing was launched


@pytest.mark.parametrize("name", KERNEL_NAMES)
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
    held = [held] + [weakref.ref(watched(n, sim.state))
                     for n in KERNEL_NAMES]
    for name in KERNEL_NAMES:
        kernel = _mod(name).KERNEL
        monkeypatch.setattr(kernel, "binding", None)
        kernel.bind(*_bound_args(name, sim))
    sim.state = saved                # what warmup's restore does
    sim.warmup()
    gc.collect()
    assert [h() for h in held] == [None] * len(held)
    for name in KERNEL_NAMES:
        assert _mod(name).KERNEL.binding is not None


def _cpu_sim(bp_size=None, n_barriers=64):
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    return Simulator(SimConfig(ConfigFile.from_string(
        "[general]\ntotal_cores = 16\n")), fft_trace(16, points_per_tile=16),
        device="cpu", bp_size=bp_size, n_barriers=n_barriers)


@pytest.mark.parametrize("bp_size,mask", [(1024, 1023), (64, 63),
                                          (1000, -1), (48, -1)])
def test_fetch_block_holds_mask_and_cost_table(bp_size, mask, monkeypatch):
    """`lane_fetch_cost`'s block: pc mod bp_size as a mask only for a
    power of two, and the static cost table read into the block."""
    mod = _mod("lane_fetch_cost")
    sim = _cpu_sim(bp_size)
    monkeypatch.setattr(mod.KERNEL, "binding", None)
    tensors, key = _bound_args("lane_fetch_cost", sim)
    words = list(mod.KERNEL.bind(tensors, key).block)
    T, L = sim.device_trace.op.shape
    n = len(tensors)
    assert words[n:n + 7] == [T, L, bp_size, mask, 1, 14, 2000]
    assert words[n + 7:] == list(sim.params.static_cost_cycles)
    assert len(words) == 52                  # sizeof(FetchArgs) / 8


def test_barrier_binding_refuses_too_many_barriers(monkeypatch):
    mod = _mod("barrier_sync")
    monkeypatch.setattr(mod.KERNEL, "binding", None)
    sim = _cpu_sim(n_barriers=mod.MAX_BARRIERS)
    words = list(mod.KERNEL.bind(*_bound_args("barrier_sync", sim)).block)
    assert words[-2:] == [16, mod.MAX_BARRIERS]
    assert len(words) == 19                  # sizeof(BarrierArgs) / 8
    sim = _cpu_sim(n_barriers=mod.MAX_BARRIERS + 1)
    with pytest.raises(ValueError, match="at most 1024"):
        mod.KERNEL.bind(*_bound_args("barrier_sync", sim))
