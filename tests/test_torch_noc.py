"""The contention NoCs of the USER net, route by route: the port's plain
versions (CPU) against graphite_tpu.

`route_hop_by_hop_plain` and `route_atac_plain` against the JAX
`route_hop_by_hop` / `route_atac` on random packets (numpy seed) over
random pre-states, at 16 and 64 tiles and on a non-square mesh (24
tiles, 4 x 6): contention on and off, every queue kind, self-sends,
models disabled, window starts that put cells past the too-old test
(the M/G/1 fallback, counted in `analytical_used`), `distance_based`
ATAC.  The arrivals (and the zero-load and contention parts) and every
column of the queues are compared; so are `scatter_queue_delay` and
`compute_queue_delay` alone, the parameters, the zero-load property of
idle hubs, and the config text of both nets.  Tolerance: zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.models import network_atac as j_atac
from graphite_tpu.models import network_hop_by_hop as j_hbh
from graphite_tpu.models import queue_models as j_qm
from graphite_tpu.tools._template import config_text as j_config_text

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.models import network_atac as t_atac
from graphite_tpu_torch.models import network_hop_by_hop as t_hbh
from graphite_tpu_torch.models import queue_models as t_qm
import torch_threads  # noqa: F401  (one intra-op thread)


QUEUE_KINDS = ("history_tree", "history_list", "basic", "m_g_1")


def hbh_text(n_tiles, kind="history_tree", contention=True):
    return (config_text(n_tiles, network="emesh_hop_by_hop")
            + "[network/emesh_hop_by_hop/queue_model]\n"
            f"enabled = {'true' if contention else 'false'}\ntype = {kind}\n")


def atac_text(n_tiles, kind="history_tree", contention=True,
              strategy="cluster_based", cluster_size=4):
    return (config_text(n_tiles, network="atac")
            + f"[network/atac]\ncluster_size = {cluster_size}\n"
            f"global_routing_strategy = {strategy}\n"
            "[network/atac/queue_model]\n"
            f"enabled = {'true' if contention else 'false'}\ntype = {kind}\n")


def both_configs(text):
    return (JSimConfig(JConfigFile.from_string(text)),
            TSimConfig(TConfigFile.from_string(text)))


def random_queues(rng, n, old_share=0.0):
    """A plausible [n, 10] queue state: busy tails, window starts below
    them (or, for `old_share` of the rows, far above every packet time,
    so the too-old test sends those cells to the M/G/1 fallback),
    non-negative newest arrivals and moments with n >= 1 where any."""
    qt = rng.integers(0, 4000, n)
    ws = np.maximum(qt - rng.integers(0, 150, n), 0)
    old = rng.random(n) < old_share
    ws = np.where(old, 10**7, ws)
    n_arr = rng.integers(0, 40, n)
    sum_st = n_arr * rng.integers(1, 12, n)
    sum_st2 = sum_st * rng.integers(1, 12, n)
    newest = np.where(n_arr > 0, rng.integers(1, 5000, n), 0)
    data = np.stack([qt, ws, newest, sum_st, sum_st2, n_arr,
                     n_arr + rng.integers(0, 5, n), sum_st,
                     rng.integers(0, 900, n), rng.integers(0, 4, n)], axis=1)
    data[-1] = 0                                  # the scratch row
    return data.astype(np.int64)


def j_queues(data, W=1):
    n = data.shape[0]
    return j_qm.QueueArrays(data=jnp.asarray(data),
                            mavg_buf=jnp.zeros((n, W), jnp.int64),
                            mavg_pos=jnp.zeros(n, jnp.int32),
                            mavg_cnt=jnp.zeros(n, jnp.int32))


def t_queues(data, W=1):
    n = data.shape[0]
    return t_qm.QueueArrays(data=torch.from_numpy(data.copy()),
                            mavg_buf=torch.zeros((n, W), dtype=torch.int64),
                            mavg_pos=torch.zeros(n, dtype=torch.int32),
                            mavg_cnt=torch.zeros(n, dtype=torch.int32))


def packets(rng, T, *, self_share=0.1, send_share=0.8):
    """One packet a lane: src = lane, a random destination (some lanes
    send to themselves), modeled bits of a 0-300 byte payload (int32,
    as the step computes them), send times spread over 3 us."""
    src = np.arange(T, dtype=np.int32)
    dst = rng.integers(0, T, T).astype(np.int32)
    dst = np.where(rng.random(T) < self_share, src, dst).astype(np.int32)
    bits = ((64 + rng.integers(0, 300, T)) * 8).astype(np.int32)
    t_send = rng.integers(0, 3_000_000, T).astype(np.int64)
    mask = rng.random(T) < send_share
    return src, dst, bits, t_send, mask


def assert_eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def route_hbh_both(text, rng, *, enabled=True, old_share=0.0, pk=None,
                   data=None):
    jc, tc = both_configs(text)
    jp = j_hbh.HopByHopParams.from_config(jc, "user")
    tp = t_hbh.HopByHopParams.from_config(tc, "user")
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    T = jp.n_tiles
    if data is None:
        data = random_queues(rng, T * 6 + 1, old_share)
    src, dst, bits, t_send, mask = pk or packets(rng, T)
    jst, ja, jz, jcn = j_hbh.route_hop_by_hop(
        jp, j_hbh.NocState(queues=j_queues(data)), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(bits), jnp.asarray(t_send),
        jnp.asarray(mask), jnp.asarray(enabled))
    tst, ta, tz, tcn = t_hbh.route_hop_by_hop_plain(
        tp, t_hbh.NocState(queues=t_queues(data)), torch.from_numpy(src),
        torch.from_numpy(dst), torch.from_numpy(bits),
        torch.from_numpy(t_send), torch.from_numpy(mask),
        torch.tensor(enabled))
    assert_eq(ja, ta, "arrival")
    assert_eq(jz, tz, "zero_load")
    assert_eq(jcn, tcn, "contention")
    assert_eq(jst.queues.data, tst.queues.data, "queues")
    return data, np.asarray(jst.queues.data), np.asarray(ja), t_send


@pytest.mark.parametrize("n_tiles", [16, 64, 24])
@pytest.mark.parametrize("kind", QUEUE_KINDS)
def test_route_hop_by_hop_equal(n_tiles, kind):
    rng = np.random.default_rng(n_tiles * 7 + QUEUE_KINDS.index(kind))
    before, after, _, _ = route_hbh_both(hbh_text(n_tiles, kind), rng)
    assert not np.array_equal(before, after)


@pytest.mark.parametrize("n_tiles", [16, 64])
def test_route_hop_by_hop_contention_off_and_disabled(n_tiles):
    rng = np.random.default_rng(3)
    before, after, arr, t_send = route_hbh_both(
        hbh_text(n_tiles, contention=False), rng)
    assert np.array_equal(before, after)
    before, after, arr, t_send = route_hbh_both(hbh_text(n_tiles), rng,
                                                enabled=False)
    assert np.array_equal(before, after) and np.array_equal(arr, t_send)


@pytest.mark.parametrize("kind", ["history_tree", "history_list"])
def test_route_hop_by_hop_mg1_fallback(kind):
    """Window starts far above every packet time: the too-old cells take
    the M/G/1 wait and count in analytical_used."""
    rng = np.random.default_rng(11)
    before, after, _, _ = route_hbh_both(hbh_text(64, kind), rng,
                                         old_share=0.5)
    ana = t_qm.COL_ANA
    assert int((after[:, ana] - before[:, ana]).sum()) > 0


def test_route_hop_by_hop_self_sends_and_hot_spots():
    """Every lane sends to itself; then every lane sends to one tile; then
    every lane of row 0 crosses the whole row; then no lane sends (the
    identity on the queues)."""
    T = 64
    rng = np.random.default_rng(5)
    lanes = np.arange(T, dtype=np.int32)
    bits = np.full(T, 640, np.int32)
    t_send = rng.integers(0, 200_000, T).astype(np.int64)
    allm = np.ones(T, bool)
    route_hbh_both(hbh_text(T), rng, pk=(lanes, lanes, bits, t_send, allm))
    route_hbh_both(hbh_text(T), rng,
                   pk=(lanes, np.full(T, 27, np.int32), bits, t_send, allm))
    row = np.where(lanes < 8, 7 - lanes, lanes).astype(np.int32)
    route_hbh_both(hbh_text(T), rng, pk=(lanes, row, bits, t_send, allm))
    before, after, arr, _ = route_hbh_both(
        hbh_text(T), rng, pk=(lanes, row, bits, t_send, ~allm))
    assert np.array_equal(before, after) and np.array_equal(arr, t_send)


def test_route_hop_by_hop_chained_calls_equal():
    """Ten calls in a row, each on the state the last one left."""
    rng = np.random.default_rng(9)
    text = hbh_text(16)
    data = np.zeros((16 * 6 + 1, 10), np.int64)
    for i in range(10):
        _, data, _, _ = route_hbh_both(text, rng, data=data)


def route_atac_both(text, rng, *, enabled=True, old_share=0.0, pk=None,
                    data=None):
    jc, tc = both_configs(text)
    jp = j_atac.AtacParams.from_config(jc, "user")
    tp = t_atac.AtacParams.from_config(tc, "user")
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    T = jp.n_tiles
    if data is None:
        data = random_queues(rng, 2 * jp.n_clusters + 1, old_share)
    src, dst, bits, clock, mask = pk or packets(rng, T)
    jst, ja, ju = j_atac.route_atac(
        jp, j_atac.AtacState(hub_queues=j_queues(data)), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(bits), jnp.asarray(clock),
        jnp.asarray(mask), jnp.asarray(enabled))
    tst, ta, tu = t_atac.route_atac_plain(
        tp, t_atac.AtacState(hub_queues=t_queues(data)),
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(bits), torch.from_numpy(clock),
        torch.from_numpy(mask), torch.tensor(enabled))
    assert_eq(ja, ta, "arrival")
    assert_eq(ju, tu, "used_onet")
    assert_eq(jst.hub_queues.data, tst.hub_queues.data, "hub queues")
    return data, np.asarray(jst.hub_queues.data), np.asarray(ja), clock


@pytest.mark.parametrize("n_tiles", [16, 64, 24])
@pytest.mark.parametrize("kind", QUEUE_KINDS)
def test_route_atac_equal(n_tiles, kind):
    rng = np.random.default_rng(100 + n_tiles + QUEUE_KINDS.index(kind))
    before, after, _, _ = route_atac_both(atac_text(n_tiles, kind), rng)
    assert not np.array_equal(before, after)


@pytest.mark.parametrize("strategy", ["cluster_based", "distance_based"])
@pytest.mark.parametrize("contention", [True, False])
def test_route_atac_strategies(strategy, contention):
    rng = np.random.default_rng(21)
    before, after, _, _ = route_atac_both(
        atac_text(64, strategy=strategy, contention=contention), rng)
    assert np.array_equal(before, after) != contention


def test_route_atac_disabled_mg1_and_idle():
    rng = np.random.default_rng(4)
    before, after, arr, clock = route_atac_both(atac_text(64), rng,
                                                enabled=False)
    assert np.array_equal(before, after) and np.array_equal(arr, clock)
    before, after, _, _ = route_atac_both(atac_text(64), rng, old_share=0.6)
    ana = t_qm.COL_ANA
    assert int((after[:, ana] - before[:, ana]).sum()) > 0
    T = 64
    lanes = np.arange(T, dtype=np.int32)
    pk = (lanes, np.full(T, 63, np.int32), np.full(T, 512, np.int32),
          np.full(T, 7_000, np.int64), np.zeros(T, bool))
    before, after, arr, clock = route_atac_both(atac_text(T), rng, pk=pk)
    assert np.array_equal(before, after) and np.array_equal(arr, clock)


def test_route_atac_chained_calls_equal():
    rng = np.random.default_rng(8)
    text = atac_text(16)
    data = np.zeros((2 * 4 + 1, 10), np.int64)
    for _ in range(10):
        _, data, _, _ = route_atac_both(text, rng, data=data)


def test_route_atac_matches_zeroload_on_idle_hubs():
    """`atac_zeroload_ps` equals `route_atac_plain` on fresh hub queues
    (tests/test_atac.py's property, on the port), and equals the JAX
    zero-load latency."""
    _, tc = both_configs(atac_text(16))
    jc, _ = both_configs(atac_text(16))
    p = t_atac.AtacParams.from_config(tc, "user")
    jp = j_atac.AtacParams.from_config(jc, "user")
    src = torch.arange(16, dtype=torch.int32)
    for dst_val in (0, 5, 10, 15):
        dst = torch.full((16,), dst_val, dtype=torch.int32)
        t0 = torch.full((16,), 1_000_000, dtype=torch.int64)
        st = t_atac.init_atac_state(p, "cpu")
        _, arrival, _ = t_atac.route_atac_plain(
            p, st, src, dst, torch.full((16,), 512, dtype=torch.int64), t0,
            torch.ones(16, dtype=torch.bool), torch.tensor(True))
        zl = t_atac.atac_zeroload_ps(p, src, dst, 512, torch.tensor(True))
        assert torch.equal(arrival, t0 + zl), dst_val
        jzl = j_atac.atac_zeroload_ps(jp, jnp.asarray(src.numpy()),
                                      jnp.asarray(dst.numpy()), 512, True)
        assert_eq(jzl, zl, "zero-load")
        assert_eq(j_atac.atac_use_onet(jp, jnp.asarray(src.numpy()),
                                       jnp.asarray(dst.numpy())),
                  t_atac.atac_use_onet(p, src, dst), "use_onet")


@pytest.mark.parametrize("kind", QUEUE_KINDS)
def test_scatter_queue_delay_equal(kind):
    """Lanes that share queues (duplicate ids), some masked off, against
    the JAX scatter form, three calls in a row."""
    rng = np.random.default_rng(31)
    p = j_qm.QueueParams(kind=kind)
    assert dataclasses.asdict(p) == dataclasses.asdict(t_qm.QueueParams(kind))
    data = random_queues(rng, 9, old_share=0.3)
    jq, tq = j_queues(data), t_queues(data)
    for _ in range(3):
        L = 40
        qid = rng.integers(0, 8, L).astype(np.int32)
        t = rng.integers(0, 6000, L).astype(np.int64)
        proc = rng.integers(0, 12, L).astype(np.int64)
        mask = rng.random(L) < 0.7
        jq, jd = j_qm.scatter_queue_delay(
            p, jq, jnp.asarray(qid), jnp.asarray(t), jnp.asarray(proc),
            jnp.asarray(mask))
        tq, td = t_qm.scatter_queue_delay(
            t_qm.QueueParams(kind), tq, torch.from_numpy(qid),
            torch.from_numpy(t), torch.from_numpy(proc),
            torch.from_numpy(mask))
        assert_eq(jd, td, "delay")
        assert_eq(jq.data, tq.data, "queues")


@pytest.mark.parametrize("kind,mavg", [
    ("history_tree", False), ("history_list", False), ("basic", False),
    ("basic", True), ("m_g_1", False)])
def test_compute_queue_delay_equal(kind, mavg):
    """One queue a lane, against the JAX form, five calls in a row (the
    moving average of `basic` included)."""
    rng = np.random.default_rng(17)
    p = j_qm.QueueParams(kind=kind, moving_avg_enabled=mavg,
                         moving_avg_window=4)
    tp = t_qm.QueueParams(kind=kind, moving_avg_enabled=mavg,
                          moving_avg_window=4)
    jq, tq = j_qm.make_queues(12, p), t_qm.make_queues(12, tp, "cpu")
    data = random_queues(rng, 12, old_share=0.3)
    jq = jq.replace(data=jnp.asarray(data))
    tq = t_qm.QueueArrays(torch.from_numpy(data.copy()), tq.mavg_buf,
                          tq.mavg_pos, tq.mavg_cnt)
    for _ in range(5):
        t = rng.integers(0, 6000, 12).astype(np.int64)
        proc = rng.integers(0, 12, 12).astype(np.int64)
        mask = rng.random(12) < 0.7
        jq, jd = j_qm.compute_queue_delay(p, jq, jnp.asarray(t),
                                          jnp.asarray(proc),
                                          jnp.asarray(mask))
        tq, td = t_qm.compute_queue_delay(tp, tq, torch.from_numpy(t),
                                          torch.from_numpy(proc),
                                          torch.from_numpy(mask))
        assert_eq(jd, td, "delay")
        for f in ("data", "mavg_buf", "mavg_pos", "mavg_cnt"):
            assert_eq(getattr(jq, f), getattr(tq, f), f)


@pytest.mark.parametrize("network", ["emesh_hop_by_hop", "atac"])
def test_config_text_equal(network):
    """The benchmark scripts' config text of both nets, byte for byte."""
    for clock_scheme in ("lax", "lax_barrier"):
        assert (config_text(256, network=network, clock_scheme=clock_scheme)
                == j_config_text(256, network=network,
                                 clock_scheme=clock_scheme))
