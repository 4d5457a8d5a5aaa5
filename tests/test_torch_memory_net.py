"""The MEMORY net under emesh_hop_by_hop and atac: graphite_tpu_torch (CPU)
against graphite_tpu.

Unicast (`memory/net.py` `mem_net_send`) and multicast (`mem_net_fanout`)
against the JAX `graphite_tpu.memory.engine` functions on random
packets and random queue states (numpy seed), net by net: contention on
and off, models disabled, window starts past every packet (the M/G/1
fallback), and ATAC homes of one cluster fanning out together.  A
masked route leaves the queues as they were (the CPU path's phase gates
rely on it); a fan-out with one target equals the unicast.  Whole runs,
port against JAX: the serialized and line-disjoint MSI cases of
tests/test_memory_net.py (tests/test_torch_memory_net_runs.py has the
stress run and the mid-run handoff).  Every SimResults field, the
summary, the line census and `MemState.noc` are equal: zero tolerance.
Marker `cuda`: the memory kernels against their plain versions on a
card.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.memory import engine as j_engine
from graphite_tpu.memory.params import MemParams as JMemParams
from graphite_tpu.models import network_atac as j_atac
from graphite_tpu.models import network_hop_by_hop as j_hbh

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.convert import state_to_arrays
from graphite_tpu_torch.memory.net import mem_net_fanout, mem_net_send
from graphite_tpu_torch.memory.params import MemParams as TMemParams
from graphite_tpu_torch.models import network_atac as t_atac
from graphite_tpu_torch.models import network_hop_by_hop as t_hbh
from graphite_tpu_torch.models.queue_models import COL_ANA, COL_REQS

from test_memory_net import ATAC_EXTRA, disjoint_stream, mutex_rmw
from test_torch_engine import port_sim
from test_torch_memory import mem_text, run_both
from test_torch_noc import assert_eq, j_queues, random_queues, t_queues

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("emesh_hop_by_hop", "atac")
CASES = ("contention", "contention_off", "disabled", "mg1_fallback")


def net_text(n_tiles, net, *, contention=True, extra=""):
    """tests/test_memory_net.py's make_config (MSI, magic USER net) with
    `net` as the MEMORY net."""
    if net == "atac":
        extra = ATAC_EXTRA.replace(
            "enabled = true", f"enabled = {str(contention).lower()}") + extra
    elif not contention:
        extra = ("[network/emesh_hop_by_hop/queue_model]\nenabled = false\n"
                 + extra)
    return mem_text(n_tiles, net=net, extra=extra)


def both_params(text):
    return (JMemParams.from_config(JSimConfig(JConfigFile.from_string(text))),
            TMemParams.from_config(TSimConfig(TConfigFile.from_string(text))))


def random_nocs(jp, tp, rng, old_share=0.0):
    """One random queue state, as the JAX and as the port's NoC state."""
    if jp.net_hbh is not None:
        data = random_queues(rng, jp.n_tiles * 6 + 1, old_share)
        return (j_hbh.NocState(queues=j_queues(data)),
                t_hbh.NocState(queues=t_queues(data)))
    data = random_queues(rng, 2 * jp.net_atac.n_clusters + 1, old_share)
    return (j_atac.AtacState(hub_queues=j_queues(data)),
            t_atac.AtacState(hub_queues=t_queues(data)))


def qdata(noc) -> np.ndarray:
    q = noc.queues if hasattr(noc, "queues") else noc.hub_queues
    return np.asarray(q.data)


@pytest.mark.parametrize("net", NETS)
def test_params_equal(net):
    """MemParams' contention model and its zero-load basis (the kind, the
    NETWORK_USER-domain frequency, the mesh, the hop and flit sizes) are
    the JAX package's under both nets."""
    jp, tp = both_params(net_text(16, net))
    for f in ("net_kind", "net_freq_mhz", "mesh_width",
              "hop_latency_cycles", "flit_width_bits", "req_bits",
              "rep_bits"):
        assert getattr(jp, f) == getattr(tp, f), f
    for f in ("net_hbh", "net_atac"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f
    assert (tp.net_hbh if net == NETS[0] else tp.net_atac) is not None


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("net", NETS)
def test_mem_net_send_equal(net, case):
    """Random unicasts (requests, replies, acks: header-only and
    line-carrying) from every tile over a random queue state."""
    jp, tp = both_params(net_text(16, net,
                                  contention=case != "contention_off"))
    rng = np.random.default_rng(NETS.index(net) * 10 + CASES.index(case))
    jn, tn = random_nocs(jp, tp, rng,
                         old_share=0.6 if case == "mg1_fallback" else 0.0)
    T = 16
    src = np.arange(T, dtype=np.int32)
    dst = rng.integers(0, T, T).astype(np.int32)
    bits = np.where(rng.random(T) < 0.5, jp.rep_bits, jp.req_bits)
    t0 = rng.integers(0, 3_000_000, T).astype(np.int64)
    mask = rng.random(T) < 0.8
    en = case != "disabled"
    jn2, ja = j_engine.mem_net_send(
        jp, jn, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(bits),
        jnp.asarray(t0), jnp.asarray(mask), jnp.asarray(en))
    tn2, ta = mem_net_send(
        tp, tn, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(bits), torch.from_numpy(t0),
        torch.from_numpy(mask), torch.tensor(en))
    assert_eq(ja, ta, "arrival")
    assert_eq(qdata(jn2), qdata(tn2), "queues")
    before, after = qdata(tn), qdata(tn2)
    if case in ("contention_off", "disabled"):
        assert np.array_equal(before, after)
    else:
        assert (after[:, COL_REQS] > before[:, COL_REQS]).any()
    if case == "disabled":
        assert_eq(ta, t0, "arrival while models are off")
    if case == "mg1_fallback":
        assert (after[:, COL_ANA] > before[:, COL_ANA]).any()


@pytest.mark.parametrize("case", CASES + ("one_cluster",))
@pytest.mark.parametrize("net", NETS)
def test_mem_net_fanout_equal(net, case):
    """Random INV multicasts from random homes over a random queue state;
    `one_cluster`: the four homes of ATAC cluster 0 (tiles 0, 1, 4, 5)
    fan out in one call and share its send hub."""
    jp, tp = both_params(net_text(16, net,
                                  contention=case != "contention_off"))
    rng = np.random.default_rng(100 + NETS.index(net) * 10
                                + (CASES + ("one_cluster",)).index(case))
    jn, tn = random_nocs(jp, tp, rng,
                         old_share=0.6 if case == "mg1_fallback" else 0.0)
    T = 16
    send = rng.random((T, T)) < 0.35
    fanning = (np.isin(np.arange(T), (0, 1, 4, 5)) if case == "one_cluster"
               else rng.random(T) < 0.6)
    send &= fanning[:, None]
    t0 = rng.integers(0, 3_000_000, T).astype(np.int64)
    en = case != "disabled"
    jn2, ja = j_engine.mem_net_fanout(jp, jn, jnp.asarray(send),
                                      jp.req_bits, jnp.asarray(t0),
                                      jnp.asarray(en))
    tn2, ta = mem_net_fanout(tp, tn, torch.from_numpy(send), tp.req_bits,
                             torch.from_numpy(t0), torch.tensor(en))
    assert_eq(np.where(send, ja, 0), np.where(send, ta.numpy(), 0),
              "arrival")
    assert_eq(qdata(jn2), qdata(tn2), "queues")
    before, after = qdata(tn), qdata(tn2)
    if case in ("contention_off", "disabled"):
        assert np.array_equal(before, after)
    else:
        assert (after[:, COL_REQS] > before[:, COL_REQS]).any()
    if case == "mg1_fallback":
        assert (after[:, COL_ANA] > before[:, COL_ANA]).any()
    if case == "one_cluster" and net == "atac":
        # one charge a fanning home with ONet copies, on the same hub
        onet = t_atac.atac_use_onet(tp.net_atac, torch.arange(T)[:, None],
                                    torch.arange(T)[None, :]).numpy()
        homes = int(((send & onet).any(axis=1)).sum())
        assert homes >= 2
        assert after[0, COL_REQS] - before[0, COL_REQS] == homes


@pytest.mark.parametrize("net", NETS)
def test_masked_routes_leave_the_queues(net):
    """No packet live (mask all False, or models off) and no home
    fanning: the queues stay as they were.  The CPU path skips a phase
    whose predicate is false; this is what makes that exact."""
    jp, tp = both_params(net_text(16, net))
    rng = np.random.default_rng(7)
    _, tn = random_nocs(jp, tp, rng, old_share=0.3)
    before = qdata(tn).copy()
    T = 16
    src = torch.arange(T, dtype=torch.int32)
    dst = torch.from_numpy(rng.integers(0, T, T).astype(np.int32))
    t0 = torch.from_numpy(rng.integers(0, 3_000_000, T).astype(np.int64))
    for mask, en in ((torch.zeros(T, dtype=torch.bool), True),
                     (torch.ones(T, dtype=torch.bool), False)):
        tn2, arr = mem_net_send(tp, tn, src, dst, tp.rep_bits, t0, mask,
                                torch.tensor(en))
        assert np.array_equal(before, qdata(tn2))
        assert torch.equal(arr, t0)
    tn2, _ = mem_net_fanout(tp, tn, torch.zeros((T, T), dtype=torch.bool),
                            tp.req_bits, t0, torch.tensor(True))
    assert np.array_equal(before, qdata(tn2))


@pytest.mark.parametrize("net", ("emesh_hop_counter",) + NETS)
def test_single_target_fanout_equals_unicast(net):
    """On an idle NoC, a fan-out with exactly one target arrives when the
    unicast of the same pair does (`test_memory_net.py:308`)."""
    tp = both_params(net_text(16, net))[1]
    T = 16
    t0 = torch.full((T,), 1_000_000, dtype=torch.int64)
    on = torch.tensor(True)

    def idle():
        if tp.net_hbh is not None:
            return t_hbh.init_noc_state(tp.net_hbh, "cpu")
        if tp.net_atac is not None:
            return t_atac.init_atac_state(tp.net_atac, "cpu")
        return None

    for src, dst in ((0, 5), (4, 4), (8, 1), (0, 15), (6, 3)):
        send = torch.zeros((T, T), dtype=torch.bool)
        send[src, dst] = True
        _, fan = mem_net_fanout(tp, idle(), send, 128, t0, on)
        mask = torch.zeros(T, dtype=torch.bool)
        mask[src] = True
        _, uni = mem_net_send(tp, idle(), torch.full((T,), src),
                              torch.full((T,), dst), 128, t0, mask, on)
        assert int(fan[src, dst]) == int(uni[src]), (net, src, dst)


def assert_noc_equal(js, ts):
    j = jax.device_get(js.state.mem.noc)
    t = state_to_arrays(ts.state)["mem"]["noc"]
    name = "queues" if hasattr(j, "queues") else "hub_queues"
    for leaf, a in dataclasses.asdict(getattr(j, name)).items():
        a = np.asarray(a)
        assert a.dtype == t[name][leaf].dtype, leaf
        np.testing.assert_array_equal(a, t[name][leaf], err_msg=leaf)
    return t[name]["data"]


@pytest.mark.parametrize("net", NETS)
def test_serialized_mutex_rmw_equal(net):
    """Mutex-serialized shared-line read-modify-writes
    (test_memory_net.py's bit-exact regime): 4 tiles under hop-by-hop,
    16 tiles (four ATAC clusters) under ATAC."""
    n = 4 if net == NETS[0] else 16
    batch = (mutex_rmw(4, rounds=6) if net == NETS[0]
             else mutex_rmw(16, rounds=3, lines=2))
    jr, tr, js, ts = run_both(net_text(n, net), batch)
    assert int(tr.mem_counters["l2_misses"].sum()) > 0
    assert assert_noc_equal(js, ts)[:, COL_REQS].sum() > 0


def test_disjoint_streams_equal():
    """Line-disjoint concurrent streams: capacity misses whose packets
    contend for the hop-by-hop memory net's ports."""
    jr, tr, js, ts = run_both(net_text(4, NETS[0]), disjoint_stream(4))
    assert int(tr.mem_counters["l2_misses"].sum()) > 0
    assert assert_noc_equal(js, ts)[:, COL_REQS].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("net", NETS)
def test_memory_kernels_equal_plain_versions_on_card(net):
    """On a CUDA host: the 16-tile stress run under `net`, the memory
    kernels (the route inside each) and `mem_net_route` against their
    plain versions iteration by iteration (chip_smoke.py does the same on
    the 64-tile companion and edge states)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    sys.path.insert(0, REPO)
    import chip_smoke

    sim = chip_smoke.memstress(16, "cuda", n_accesses=60,
                               extra=f"[network]\nmemory = {net}\n")
    stats = chip_smoke.new_stats()
    chip_smoke.run_checked(sim, 300, stats)
    for name in chip_smoke.MEM_KERNELS[:3] + ("mem_net_route",):
        assert stats[name]["checks"] > 0, name
        assert stats[name]["max_abs_err"] == 0, name


@pytest.mark.parametrize("net", NETS)
def test_kernel_blocks_end_with_the_net(net):
    """Every memory kernel's argument block ends with `NetConsts` (the
    MEMORY net's queue rows and accumulator scratch, then its values),
    and `MemConsts.net_kind` picks the routed instantiation; on CPU
    tensors `mem_net_route` runs its plain version and launches
    nothing."""
    import importlib

    from graphite_tpu_torch import ops

    mnr = importlib.import_module("graphite_tpu_torch.ops.mem_net_route")
    mreq = importlib.import_module("graphite_tpu_torch.ops.mem_requester")

    ts = port_sim(net_text(16, net), mutex_rmw(16, rounds=1))
    mp, ms = ts.params.mem, ts.state.mem
    tensors, key = mreq.bound_args(ts.models.mem, ms, ts._lanes,
                                   ts.device_trace, ts.state.core,
                                   ts.state.models_enabled,
                                   ts._lanes.progress)
    block = list(mreq._pack(tensors, key))
    q, scratch = mnr.net_tensors(mp, ms.noc)
    assert block[-22:-20] == [q.data_ptr(),
                              0 if scratch is None else scratch.data_ptr()]
    assert tuple(block[-20:]) == mnr.net_values(mp.net_hbh, mp.net_atac)
    assert block[len(tensors) - 2 + 1 + 10] == (2 if net == NETS[0] else 3)
    T = 16
    before = ops.launch_counts()
    arr = mnr.mem_net_route(mp, ms.noc, torch.arange(T), torch.zeros(
        T, dtype=torch.int64), mp.req_bits, torch.zeros(T, dtype=torch.int64),
        torch.ones(T, dtype=torch.bool), ts.state.models_enabled)
    assert ops.launch_counts() == before and bool((arr[1:] > 0).all())


def test_card_limits_raise_at_construction():
    """On a card, `Simulator(...)` raises the one-CTA kernels' own
    refusals (`check_card_limits`, called here with a wider path's
    parameters); CPU runs are not limited."""
    from graphite_tpu_torch.engine.simulator import check_card_limits

    ts = port_sim(net_text(16, "atac"), mutex_rmw(16, rounds=1),
                  n_barriers=2048)
    p = ts.params
    check_card_limits(p, 1024)
    wide = dataclasses.replace(p, n_tiles=2048)
    with pytest.raises(ValueError, match="mem_requester: 2048 tiles, at "
                       "most 1024"):
        check_card_limits(wide, 64)
    with pytest.raises(ValueError, match="atac_route: 2048 lanes"):
        check_card_limits(dataclasses.replace(wide, mem=None,
                                              user_atac=p.mem.net_atac), 64)
    with pytest.raises(ValueError, match="barrier_sync: 2048 barriers"):
        check_card_limits(p, 2048)
