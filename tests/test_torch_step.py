"""One graphite_tpu_torch step against one graphite_tpu step, leaf by leaf.

JAX runs `subquantum_iteration` (jitted once per trace) for k iterations;
the state it reaches is converted with `convert.state_from_arrays`, the
port takes ONE step on the CPU — through the plain versions of its four
kernels (`lane_fetch_cost`, `user_mailbox`, `barrier_sync`,
`lane_commit`) and its PyTorch units — and every new-state leaf and the
advanced-lane count must equal JAX's step k+1.  Crafted random states
drive the corners real traces rarely reach (ANY_SENDER ties, full rings,
barrier-init races, split barriers, pending cond signals, DVFS_SET
validation, the qend bound of plain-run batching).  Tolerance: zero.
"""

import dataclasses

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
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import (
    state_from_arrays, state_to_arrays, trace_from_arrays,
)
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.engine.step import ALL_UNITS
from graphite_tpu_torch.engine.step import (
    subquantum_iteration as t_step,
)
import torch_threads  # noqa: F401  (one intra-op thread)


def config_text(n_tiles, scheme="lax", user="emesh_hop_counter", extra=""):
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 2.0
[network]
user = {user}
memory = magic
[network/emesh_hop_counter]
flit_width = 64
[network/emesh_hop_counter/router]
delay = 1
[network/emesh_hop_counter/link]
delay = 1
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
imul = 3
idiv = 18
falu = 3
fmul = 5
fdiv = 6
branch = 1
mfence = 7
[branch_predictor]
type = one_bit
mispredict_penalty = 14
size = 64
[clock_skew_management]
scheme = {scheme}
[clock_skew_management/lax_barrier]
quantum = 1000
{extra}
"""


def sync_heavy_batch(n_tiles=16, seed=0) -> TraceBatch:
    """Every machinery unit, in an order that completes: compute mixes
    with branches (high pcs), dynamic costs, BBLOCK, SYSCALL and DVFS
    records; a global barrier between phases; mutex critical sections;
    named + ANY_SENDER messaging; the split barrier; a broadcast to cond
    waiters; a published signal + COND_JOIN; DVFS_SET; a models
    disable/enable window; spawn and join."""
    T = n_tiles
    rng = np.random.default_rng(seed)
    bs = [TraceBuilder() for _ in range(T)]
    bs[0].barrier_init(0, T).barrier_init(2, T)
    bs[0].mutex_init(0).mutex_init(1).mutex_init(2).cond_init(1)

    def compute(b, n):
        for _ in range(n):
            k = rng.integers(0, 6)
            if k == 0:
                b.branch(bool(rng.integers(0, 2)),
                         pc=int(rng.choice([0x40, 0x44, 0xFFFFFFC0])))
            elif k == 1:
                b.dynamic(Op.STALL, int(rng.integers(0, 3000)))
            elif k == 2:
                b.bblock(int(rng.integers(1, 9)), int(rng.integers(1, 30)))
            else:
                b.instr(Op(int(rng.choice([1, 2, 3, 5, 6, 7, 14]))))

    def barrier():
        for b in bs:
            b.barrier_wait(0)

    for t, b in enumerate(bs):
        compute(b, int(rng.integers(3, 12)))
        if t % 3 == 0:
            b.syscall(2, 64)
        if t % 4 == 1:
            b._append(Op.DVFS_GET, aux0=0)
    barrier()
    for t, b in enumerate(bs):                      # critical sections
        b.mutex_lock(t % 2)
        compute(b, int(rng.integers(1, 4)))
        b.mutex_unlock(t % 2)
    barrier()
    for t, b in enumerate(bs):                      # messaging
        b.send((t + 1) % T, 8).send((t + 3) % T, 32)
        compute(b, int(rng.integers(0, 5)))
        b.recv((t - 1) % T, 8).recv(-1, 32)
    barrier()
    for t, b in enumerate(bs):                      # split barrier
        b.barrier_arrive(2)
        compute(b, int(rng.integers(0, 6)))
        b.barrier_sync(2, 1)
    barrier()
    bs[4].cond_signal(3, publish=True)              # published form
    bs[5].cond_join(3, 1)
    bs[6].dvfs_set(0, 500).instr(Op.IMUL).dvfs_set(0, 3000)
    bs[7].dvfs_set(0, 1000, hold=True).dvfs_set(9, 1000)
    bs[8]._append(Op.DISABLE_MODELS)
    compute(bs[8], 5)
    bs[8]._append(Op.ENABLE_MODELS)
    bs[T - 1].dynamic(Op.SPAWN, 900_000)
    compute(bs[T - 1], 3)
    barrier()
    for b in bs:
        compute(b, int(rng.integers(0, 20)))
    # cond broadcast last: a tile parked at a barrier would hold the
    # engine's time-order delivery guard below the broadcast time
    for t in (1, 2, 3):
        bs[t].mutex_lock(2).cond_wait(1, 2).instr(Op.IALU).mutex_unlock(2)
    compute(bs[0], 40)
    bs[0].mutex_lock(2).cond_broadcast(1).mutex_unlock(2)
    bs[0].thread_join(T - 1)
    return TraceBatch.from_builders(bs)


def random_op_batch(n_tiles=16, length=24, seed=0) -> TraceBatch:
    """A trace whose records are drawn from every op class (for the
    crafted-state steps; it is never run to completion)."""
    rng = np.random.default_rng(seed)
    pool = np.array([0, 1, 2, 3, 4, 5, 11, 11, 14, 15, 16, 18, 19]
                    + list(range(32, 55)) + [255], np.uint8)
    T, L = n_tiles, length
    op = rng.choice(pool, size=(T, L)).astype(np.uint8)
    z = lambda d: np.zeros((T, L), d)  # noqa: E731
    return TraceBatch(
        op=op,
        # no memory-operand bits: the memory subsystem is not ported
        flags=(rng.integers(0, 256, (T, L)) & 0xFC).astype(np.uint8),
        pc=rng.integers(0, 2**32, (T, L)).astype(np.uint32),
        addr0=z(np.uint32), addr1=z(np.uint32),
        size0=z(np.uint8), size1=z(np.uint8),
        aux0=rng.integers(-1, T, (T, L)).astype(np.int32),
        aux1=rng.integers(-600, 3000, (T, L)).astype(np.int32),
        dyn_ps=rng.integers(0, 50_000, (T, L)).astype(np.int64),
        rreg0=z(np.uint16), rreg1=z(np.uint16), wreg=z(np.uint16),
    )


def make_pair(text, batch, **kw):
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch, **kw)
    ts = TSimulator(TSimConfig(TConfigFile.from_string(text)),
                    trace_from_arrays(batch.__dict__), device="cpu", **kw)
    return js, ts


def _flat(tree, prefix=""):
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        return {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def port_step(ts, host_state, qend, units=None):
    """One port step from a JAX host state; returns (arrays, advanced)."""
    st = state_from_arrays(host_state, "cpu")
    lanes = Lanes.zeros(ts.params.n_tiles, "cpu")
    params = ts.params if units is None else dataclasses.replace(
        ts.params, units=units)
    t_step(params, ts.device_trace, st, torch.tensor(qend), lanes,
           ts._cost_table)
    return state_to_arrays(st), int(lanes.progress.item())


def assert_step_equal(j_next, j_adv, t_next, t_adv, where=""):
    a, b = _flat(j_next), _flat(t_next)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
    assert j_adv == t_adv, where


def jax_trajectory(js, qend, n):
    step = jax.jit(lambda st: j_step(js.params, js.device_trace, st,
                                     jnp.asarray(qend, jnp.int64)))
    st = js.state
    hosts, advs = [jax.device_get(st)], []
    for _ in range(n):
        st, adv = step(st)
        hosts.append(jax.device_get(st))
        advs.append(int(adv))
    return hosts, advs


@pytest.mark.parametrize("case", ["fft16_lax", "fft16_qend", "sync16_lax",
                                  "sync16_qend"])
def test_step_matches_jax_along_a_run(case):
    if case.startswith("fft"):
        batch = j_fft(16, points_per_tile=32)
        probes = (0, 1, 2, 5, 17, 20, 33, 40, 47, 60)
    else:
        batch = sync_heavy_batch(16)
        probes = (0, 1, 2, 3, 8, 15, 25, 40, 60, 80, 100, 120, 139)
    qend = 2**61 if case.endswith("lax") else 40_000
    js, ts = make_pair(config_text(16), batch)
    hosts, advs = jax_trajectory(js, qend, max(probes) + 1)
    for k in probes:
        t_next, t_adv = port_step(ts, hosts[k], qend)
        assert_step_equal(hosts[k + 1], advs[k], t_next, t_adv,
                          f"{case} step {k}")
        # running every unit (no unit gating) changes nothing
        t_all, t_adv_all = port_step(ts, hosts[k], qend, ALL_UNITS)
        assert_step_equal(hosts[k + 1], advs[k], t_all, t_adv_all,
                          f"{case} step {k} ungated")


def _random_state(rng, base, T, D, NB, NC, NM, K, dvfs_params):
    r = lambda lo, hi, shape, dt: rng.integers(lo, hi, shape).astype(dt)  # noqa
    b = lambda p, shape: rng.random(shape) < p  # noqa: E731
    core = base.core.replace(
        clock_ps=r(0, 60, T, np.int64) * 1000 + r(0, 3, T, np.int64),
        idx=r(0, 26, T, np.int32),
        freq_mhz=rng.choice([333, 500, 1000, 1500, 2000], T).astype(
            np.int32),
        instruction_count=r(0, 99, T, np.int64),
        bp_bits=r(0, 2, base.core.bp_bits.shape, np.uint8),
        sync_stall_ps=r(0, 999, T, np.int64),
    )
    count = r(0, D + 1, (T, T), np.int32)
    net = base.net.replace(
        time_ps=r(0, 40, (T, D, T), np.int64) * 500,     # many ties
        lat_ps=r(0, 3000, (T, D, T), np.int32),
        head=count + r(0, 5, (T, T), np.int32),
        count=count,
    )
    bcount = r(0, 12, NB, np.int32)
    arrived = np.where(bcount > 0, rng.integers(0, np.maximum(bcount, 1)),
                       r(0, 9, NB, np.int32)).astype(np.int32)
    far = 2**62
    psig = np.where(b(0.5, (NC, K)), far, r(0, 60_000, (NC, K), np.int64))
    sync = base.sync.replace(
        barrier_count=bcount,
        barrier_arrived=arrived,
        barrier_time_ps=r(0, 60_000, NB, np.int64),
        barrier_waiting=b(0.3, T),
        barrier_gen=r(0, 20, NB, np.int32),
        barrier_release_ps=r(0, 60_000, (NB, 8), np.int64),
        cond_sig_seq=r(0, 9, NC, np.int32),
        cond_sig_seq_ps=r(0, 60_000, (NC, 8), np.int64),
        mutex_locked=r(0, 2, NM, np.int32),
        mutex_owner=r(-1, T, NM, np.int32),
        mutex_time_ps=r(0, 60_000, NM, np.int64),
        mutex_waiting=b(0.3, T),
        cond_waiting=b(0.3, T),
        cond_signaled=b(0.1, T),
        cond_arrival_ps=r(0, 60_000, T, np.int64),
        cond_wake_ps=r(0, 60_000, T, np.int64),
        cond_sig_time_ps=psig.astype(np.int64),
        cond_bcast_time_ps=np.where(b(0.6, NC), far,
                                    r(0, 60_000, NC, np.int64)),
    )
    nd = base.dvfs.freq_mhz.shape[1]
    volts = np.asarray(dvfs_params.voltages_mv, np.int32)
    dvfs = base.dvfs.replace(
        freq_mhz=rng.choice([500, 1000, 2000], (T, nd)).astype(np.int32),
        voltage_mv=rng.choice(volts, (T, nd)).astype(np.int32),
    )
    return base.replace(core=core, net=net, sync=sync, dvfs=dvfs,
                        done=b(0.1, T),
                        models_enabled=np.asarray(bool(rng.integers(0, 4))))


@pytest.mark.parametrize("qend", [2**61, 30_000])
def test_step_matches_jax_on_crafted_states(qend):
    batch = random_op_batch(16, 24)
    js, ts = make_pair(config_text(16), batch, mailbox_depth=3,
                       n_barriers=6, n_mutexes=4, n_conds=5)
    assert ts.params.units == ALL_UNITS
    step = jax.jit(lambda st: j_step(js.params, js.device_trace, st,
                                     jnp.asarray(qend, jnp.int64)))
    base = jax.device_get(js.state)
    rng = np.random.default_rng(7 if qend > 2**40 else 8)
    K = base.sync.cond_sig_time_ps.shape[1]
    for i in range(12):
        host = _random_state(rng, base, 16, 3, 6, 5, 4, K,
                             js.params.dvfs)
        j_next, j_adv = step(jax.device_put(host))
        t_next, t_adv = port_step(ts, host, qend)
        assert_step_equal(jax.device_get(j_next), int(j_adv), t_next,
                          t_adv, f"crafted state {i}")
