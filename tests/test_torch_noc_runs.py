"""The contention NoCs of the USER net, whole runs: graphite_tpu_torch
(CPU) against graphite_tpu.

RADIX (`radix_trace`) at 16 and 64 tiles under emesh_hop_by_hop and
atac, `lax` and `lax_barrier`; the scenarios of tests/test_hop_by_hop.py
(ping-pong, a token ring, mutex-serialized crossing traffic, free-running
uniform traffic) and of tests/test_atac.py (intra-cluster ENet,
inter-cluster ONet, hub compounding, the 64-tile mesh); a JAX run handed
to the port mid-way (`convert.py`); the port's `radix_trace` against the
JAX builder at 256 tiles; the FFT with its loads under both nets as the
USER and the MEMORY net.  Every SimResults field, the summary, `last_n_iterations` and the
final USER-NoC queue state (`state.noc_user`, every leaf) are equal:
zero tolerance.  Marker `cuda`: the two route kernels against their
plain versions on a card (skipped without one).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.config import ConfigFile as JConfigFile
from graphite_tpu.config import SimConfig as JSimConfig
from graphite_tpu.engine.simulator import Simulator as JSimulator
from graphite_tpu.tools._template import config_text as j_config_text
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.benchmarks import radix_trace as j_radix
from graphite_tpu.trace.schema import Op, TraceBatch, TraceBuilder

from graphite_tpu_torch.config import ConfigFile as TConfigFile
from graphite_tpu_torch.config import SimConfig as TSimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.convert import state_from_arrays, state_to_arrays
from graphite_tpu_torch.engine.simulator import Simulator as TSimulator
from graphite_tpu_torch.trace.benchmarks import radix_trace as t_radix
from graphite_tpu_torch.trace.schema import _FIELDS

from test_torch_engine import assert_results_equal, port_sim
from test_torch_memory import jax_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("emesh_hop_by_hop", "atac")


def _leaves(tree, prefix=""):
    if tree is None:
        return {}
    if hasattr(tree, "__dataclass_fields__"):
        out = {}
        for name in tree.__dataclass_fields__:
            out.update(_leaves(getattr(tree, name), f"{prefix}.{name}"))
        return out
    if isinstance(tree, dict):
        out = {}
        for name, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{name}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_noc_equal(js, ts):
    """The final USER-NoC queue state, leaf for leaf (names, dtypes,
    values)."""
    j = _leaves(jax.device_get(js.state.noc_user))
    t = _leaves(state_to_arrays(ts.state)["noc_user"])
    assert j.keys() == t.keys() and j
    for name, a in j.items():
        assert a.dtype == t[name].dtype, name
        np.testing.assert_array_equal(a, t[name], err_msg=name)


def run_both(text, batch, **kw):
    batch = batch if isinstance(batch, TraceBatch) else \
        TraceBatch.from_builders(batch)
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch, **kw)
    jr = jax_run(js)
    ts = port_sim(text, batch, **kw)
    tr = ts.run()
    assert_results_equal(jr, tr)
    assert js.last_n_iterations == ts.last_n_iterations
    assert_noc_equal(js, ts)
    return jr, tr, js, ts


@pytest.mark.parametrize("n_tiles,keys", [(16, 64), (64, 128)])
@pytest.mark.parametrize("network", NETS)
@pytest.mark.parametrize("scheme", ["lax", "lax_barrier"])
def test_radix_equal(n_tiles, keys, network, scheme):
    text = config_text(n_tiles, network=network, clock_scheme=scheme)
    assert text == j_config_text(n_tiles, network=network,
                                 clock_scheme=scheme)
    jr, tr, js, ts = run_both(text, j_radix(n_tiles, keys_per_tile=keys),
                              inner_block=64)
    q = ts.state.noc_user
    data = (q.queues if network == NETS[0] else q.hub_queues).data
    assert int(data[:, 6].sum()) > 0          # the queues took requests
    assert ts.params.net.kind == "routed"


HBH_CFG = """
[general]
total_cores = 16
mode = lite
max_frequency = 1.0
enable_shared_mem = false
[network]
user = emesh_hop_by_hop
memory = magic
[network/emesh_hop_by_hop]
flit_width = 64
[network/emesh_hop_by_hop/router]
delay = 1
[network/emesh_hop_by_hop/link]
delay = 1
[core/static_instruction_costs]
ialu = 1
[clock_skew_management]
scheme = lax_barrier
[clock_skew_management/lax_barrier]
quantum = 1000
"""


def token_ring():
    bs = [TraceBuilder() for _ in range(16)]
    for lap in range(3):
        for t in range(16):
            if not (lap == 0 and t == 0):
                bs[t].recv((t - 1) % 16, 16)
            bs[t].bblock(5, 5)
            bs[t].send((t + 1) % 16, 16)
    bs[0].recv(15, 16)
    return bs


def crossing_traffic():
    bs = [TraceBuilder() for _ in range(16)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(1, 16)
    for b in bs:
        b.barrier_wait(1)
    for _ in range(3):
        for t in range(4):
            s = t * 4
            bs[s].mutex_lock(0)
            bs[s].send(15, 32)
            bs[s].mutex_unlock(0)
            bs[15].recv(s, 32)
    return bs


@pytest.mark.parametrize("scenario", [
    "ping_pong", "token_ring", "crossing_traffic", "free_running"])
def test_hop_by_hop_scenarios_equal(scenario):
    """tests/test_hop_by_hop.py's traffic: serialized (bit-exact against
    the golden interpreter there) and free-running."""
    batch = {
        "ping_pong": lambda: j_syn.ping_pong_trace(16, n_rounds=25),
        "token_ring": token_ring,
        "crossing_traffic": crossing_traffic,
        "free_running": lambda: j_syn.message_ring_batch(
            16, n_rounds=30, compute_per_round=7, pattern="uniform_random"),
    }[scenario]()
    run_both(HBH_CFG, batch)


def atac_cfg(n_tiles=16, strategy="cluster_based", contention="false"):
    """tests/test_atac.py's make_config."""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
tile_width = 1.0
[network]
user = atac
memory = magic
[network/atac]
flit_width = 64
cluster_size = 4
receive_network_type = star
global_routing_strategy = {strategy}
unicast_distance_threshold = 4
[network/atac/queue_model]
enabled = {contention}
type = history_tree
[network/atac/enet/router]
delay = 1
[network/atac/onet/send_hub/router]
delay = 1
[network/atac/onet/receive_hub/router]
delay = 1
[network/atac/star_net/router]
delay = 1
[link_model/optical]
waveguide_delay_per_mm = 10e-3
E-O_conversion_delay = 1
O-E_conversion_delay = 1
[core/static_instruction_costs]
ialu = 1
[clock_skew_management]
scheme = lax
"""


def _atac_case(name):
    bs = [TraceBuilder() for _ in range(16)]
    if name == "intra_cluster_enet":
        bs[0].send(1, 8)
        bs[1].recv(0, 8)
    elif name == "inter_cluster_onet":
        bs[0].send(15, 8)
        bs[15].recv(0, 8)
    elif name == "hub_contention":
        bs[0].send(10, 64)
        bs[1].instr(Op.IALU).send(11, 64)
        bs[10].recv(0, 64)
        bs[11].recv(1, 64)
    elif name == "hub_compounding":
        for _ in range(6):
            bs[0].send(15, 64)
        for _ in range(6):
            bs[15].recv(0, 64)
    elif name == "mixed_routes":
        for a, b in [(0, 1), (1, 12), (12, 3), (3, 3), (3, 0)]:
            bs[a].send(b, 32)
            bs[b].recv(a, 32)
    return bs


@pytest.mark.parametrize("case", [
    "intra_cluster_enet", "inter_cluster_onet", "hub_contention",
    "hub_compounding", "mixed_routes"])
@pytest.mark.parametrize("strategy,contention", [
    ("cluster_based", "true"), ("cluster_based", "false"),
    ("distance_based", "true")])
def test_atac_scenarios_equal(case, strategy, contention):
    """tests/test_atac.py's traffic, both routing strategies, the hub
    queues on and off."""
    run_both(atac_cfg(16, strategy, contention), _atac_case(case))


def test_atac_larger_mesh_equal():
    bs = []
    for t in range(64):
        b = TraceBuilder()
        b.send((t + 4) % 64, 8)
        b.recv((t - 4) % 64, 8)
        bs.append(b)
    jr, tr, _, _ = run_both(atac_cfg(64, contention="true"), bs)
    assert int(tr.packets_received.sum()) == 64


@pytest.mark.parametrize("network", NETS)
def test_mid_run_handoff_from_jax(network):
    """JAX runs half the lax_barrier quanta of RADIX; the port takes its
    state (the contention queues included) and finishes equal to the JAX
    package finishing the same state."""
    text = config_text(16, network=network, clock_scheme="lax_barrier")
    batch = j_radix(16, keys_per_tile=64)
    whole = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    n = whole.run().n_quanta
    js = JSimulator(JSimConfig(JConfigFile.from_string(text)), batch)
    done, nq = js.run_chunk(n // 2)
    assert not done and nq == n // 2 > 0
    ts = port_sim(text, batch)
    ts.state = state_from_arrays(jax.device_get(js.state), "cpu")
    assert int(ts.state.noc_user.__dict__[
        "queues" if network == NETS[0] else "hub_queues"].data.sum()) > 0
    tr = ts.run()
    jr = js.run()
    assert_results_equal(jr, tr)
    assert js.last_n_iterations == ts.last_n_iterations
    assert_noc_equal(js, ts)


def test_radix_trace_equal_at_256_tiles():
    """The port's RADIX equals the JAX builder's arrays, field for field,
    at the slice's full width (L = 2,158 records a tile)."""
    jb, tb = j_radix(256, keys_per_tile=1024), t_radix(256,
                                                       keys_per_tile=1024)
    assert tb.op.shape == (256, 2158)
    for name, dtype in _FIELDS:
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype == dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("memory_net", NETS)
@pytest.mark.parametrize("user_net", NETS)
def test_contention_memory_net_raises(user_net, memory_net):
    """A trace with memory records under either contention net as the USER
    and as the MEMORY net: the FFT with its loads runs equal to the JAX
    package, the line census, the USER net's queues and the MEMORY net's
    (`MemState.noc`) included.  The name is kept on purpose: these
    configurations raised until the MEMORY net was ported, and the test
    now pins that they run."""
    from graphite_tpu.trace.benchmarks import fft_trace as j_fft

    from test_torch_memory import run_both as mem_run_both
    from test_torch_memory_net import assert_noc_equal as assert_mem_noc

    text = config_text(16, network=user_net, shared_mem=True,
                       clock_scheme="lax") + \
        f"[network]\nmemory = {memory_net}\n"
    jr, tr, js, ts = mem_run_both(text, j_fft(16, 16, use_memory=True))
    assert_noc_equal(js, ts)
    assert assert_mem_noc(js, ts)[:, 6].sum() > 0      # COL_REQS
    assert int(tr.mem_counters["l2_misses"].sum()) > 0


def test_memory_noc_state_conversion_raises():
    """The MEMORY net's queues (`MemState.noc`) of a JAX state convert to
    the port and back, under both nets.  The name is kept on purpose: the
    conversion raised until the MEMORY net was ported, and the test now
    pins the round trip."""
    from graphite_tpu.trace.benchmarks import fft_trace as j_fft

    for net in NETS:
        text = config_text(16, shared_mem=True, clock_scheme="lax") + \
            f"[network]\nmemory = {net}\n"
        js = JSimulator(JSimConfig(JConfigFile.from_string(text)),
                        j_fft(16, 16, use_memory=True))
        host = jax.device_get(js.state)
        rng = np.random.default_rng(5)
        name = "queues" if net == NETS[0] else "hub_queues"
        q = getattr(host.mem.noc, name)
        host = host.replace(mem=host.mem.replace(noc=host.mem.noc.replace(
            **{name: q.replace(data=rng.integers(
                0, 10**6, q.data.shape).astype(np.int64))})))
        port = state_from_arrays(host, "cpu")
        back = state_to_arrays(port)["mem"]["noc"][name]
        for leaf in ("data", "mavg_buf", "mavg_pos", "mavg_cnt"):
            a = np.asarray(getattr(getattr(host.mem.noc, name), leaf))
            assert a.dtype == back[leaf].dtype, leaf
            np.testing.assert_array_equal(a, back[leaf], err_msg=leaf)
        assert int(back["data"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("network", NETS)
def test_route_kernels_equal_plain_versions_on_card(network):
    """On a CUDA host: RADIX at 64 tiles, every kernel of the step against
    its plain version, iteration by iteration (chip_smoke.py does the
    same at 256 tiles, with edge states)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    sys.path.insert(0, REPO)
    import chip_smoke

    sim = chip_smoke.radix_sim(64, network, "cuda", keys_per_tile=128)
    stats = chip_smoke.new_stats()
    chip_smoke.run_checked(sim, 300, stats)
    name = "noc_route" if network == NETS[0] else "atac_route"
    assert stats[name]["checks"] > 0 and stats[name]["max_abs_err"] == 0
    assert stats["user_mailbox"]["max_abs_err"] == 0


@pytest.mark.parametrize("name", ["noc_route", "atac_route"])
def test_route_wrappers_take_plain_version_for_cpu_tensors(name,
                                                           monkeypatch):
    """On CPU tensors each route wrapper runs its plain version, and only
    that (no kernel launch is counted); other devices are refused."""
    import importlib

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.engine.state import Lanes

    mod = importlib.import_module(f"graphite_tpu_torch.ops.{name}")
    net = NETS[0] if name == "noc_route" else NETS[1]
    ts = port_sim(config_text(16, network=net, clock_scheme="lax"),
                  j_radix(16, keys_per_tile=64))
    calls = []
    plain = getattr(mod, name + "_plain")
    monkeypatch.setattr(mod, name + "_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = ops.launch_counts()
    p = ts.params.user_hbh if name == "noc_route" else ts.params.user_atac
    st, ln = ts.state, ts._lanes
    getattr(ops, name)(p, st.noc_user, ln, st.core.clock_ps,
                       st.models_enabled)
    assert calls == [1] and ops.launch_counts() == before
    meta = Lanes.zeros(16, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(ops, name)(p, st.noc_user, meta,
                           torch.zeros(16, dtype=torch.int64, device="meta"),
                           st.models_enabled)


@pytest.mark.parametrize("name", ["noc_route", "atac_route"])
def test_route_bindings_pack_their_arguments(name):
    """Each route kernel's argument block: its tensors' pointers in the
    C struct's order, then the mesh, delays and queue-model values; a
    tensor of another shape is refused."""
    import importlib

    mod = importlib.import_module(f"graphite_tpu_torch.ops.{name}")
    net = NETS[0] if name == "noc_route" else NETS[1]
    ts = port_sim(config_text(64, network=net, clock_scheme="lax"),
                  j_radix(64, keys_per_tile=8))
    p = ts.params.user_hbh if name == "noc_route" else ts.params.user_atac
    st, ln = ts.state, ts._lanes
    tensors, key = mod.bound_args(p, st.noc_user, ln, st.core.clock_ps,
                                  st.models_enabled)
    block = list(mod._pack(tensors, key))
    assert block[:len(tensors)] == [t.data_ptr() for t in tensors]
    values = block[len(tensors):]
    if name == "noc_route":
        assert values == [64, 8, 8, 1, 1, 64, 1000, 1, 1, 100, 1]
    else:
        assert values[:7] == [64, 16, 8, 2, 2, 64, 1000]
        assert values[-4:] == [1, 1, 100, 1]
    bad = list(tensors)
    bad[6] = bad[6][:-1]                     # one queue row short
    with pytest.raises(ValueError, match="shape"):
        mod._pack(tuple(bad), key)
