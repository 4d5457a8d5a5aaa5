"""graphite_tpu_torch stands alone, and its wrappers and semantics pins.

 - the package imports and runs with `jax` and `graphite_tpu` unimportable
   (a subprocess with both blocked in sys.modules);
 - `Simulator` without `device=` needs CUDA and raises without it;
 - each of the four kernel wrappers takes its plain version for CPU
   tensors (and only then: the launch counters stay at zero);
 - unsupported configurations raise NotImplementedError naming their
   ROADMAP.md item;
 - the semantics the port must not get wrong: truncating modulo, the
   zero-extended uint32 pc, the first index of argmin/argmax ties, the
   dump bucket of the masked elections, accumulating scatters.
"""

import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import graphite_tpu_torch
from graphite_tpu_torch import ops
from graphite_tpu_torch.config import ConfigFile, SimConfig
from graphite_tpu_torch.engine.simulator import Simulator
from graphite_tpu_torch.engine.state import Lanes
from graphite_tpu_torch.ops.barrier_sync import elect_min
from graphite_tpu_torch.trace import synthetic
from graphite_tpu_torch.trace.benchmarks import fft_trace
from graphite_tpu_torch.trace.schema import (
    FLAG_MEM0_VALID, Op, TraceBatch, TraceBuilder,
)
import torch_threads  # noqa: F401  (one intra-op thread)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg(n=16, extra="", user="emesh_hop_counter", scheme="lax"):
    return SimConfig(ConfigFile.from_string(f"""
[general]
total_cores = {n}
mode = lite
[network]
user = {user}
[core/static_instruction_costs]
ialu = 1
[clock_skew_management]
scheme = {scheme}
{extra}
"""))


def test_runs_without_jax_or_graphite_tpu():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["graphite_tpu"] = None
        import graphite_tpu_torch
        from graphite_tpu_torch.config import ConfigFile, SimConfig
        from graphite_tpu_torch.engine import Simulator
        from graphite_tpu_torch.trace.benchmarks import fft_trace
        import graphite_tpu_torch.convert, graphite_tpu_torch.ops
        import graphite_tpu_torch.memory.engine
        import graphite_tpu_torch.models.iocoom
        import graphite_tpu_torch.system
        from graphite_tpu_torch.system import (
            Log, StatisticsManager, load_checkpoint, save_checkpoint)
        from graphite_tpu_torch.trace.benchmarks import BENCHMARKS
        from graphite_tpu_torch.trace.synthetic import ping_pong_trace
        from graphite_tpu_torch.config.template import config_text
        from graphite_tpu_torch.trace.synthetic import memory_stress_trace
        sc = SimConfig(ConfigFile.from_string(
            "[general]\\ntotal_cores = 16\\n[network]\\n"
            "user = emesh_hop_counter\\n[clock_skew_management]\\n"
            "scheme = lax\\n"))
        r = Simulator(sc, fft_trace(16, points_per_tile=16),
                      device="cpu").run()
        # the memory slice: iocoom + MSI on the FFT's loads, and memstress
        mc = SimConfig(ConfigFile.from_string(config_text(
            16, core="iocoom", shared_mem=True, clock_scheme="lax")))
        rm = Simulator(mc, fft_trace(16, points_per_tile=16,
                                     use_memory=True), device="cpu").run()
        rs = Simulator(mc, memory_stress_trace(16, n_accesses=10),
                       device="cpu").run()
        assert rm.mem_counters["l2_misses"].sum() > 0
        assert rs.mem_counters["l2_misses"].sum() > 0
        # this slice: lax_p2p, the generators, a checkpoint round trip
        pc = SimConfig(ConfigFile.from_string(
            "[general]\\ntotal_cores = 16\\n[clock_skew_management]\\n"
            "scheme = lax_p2p\\n"))
        sp = Simulator(pc, BENCHMARKS["blackscholes"](16, 8),
                       device="cpu")
        import os, tempfile
        ck = os.path.join(tempfile.mkdtemp(), "c.npz")
        save_checkpoint(sp, ck)
        load_checkpoint(sp, ck)
        assert sp.run().total_instructions > 0
        assert len(BENCHMARKS) == 14 and ping_pong_trace(4).n_tiles == 4
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "graphite_tpu")
                     and sys.modules[m] is not None)
        print(r.total_instructions, r.completion_time_ps, bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    total, completion, bad = out.stdout.split(maxsplit=2)
    assert int(total) > 0 and int(completion) > 0
    assert bad.strip() == "[]"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(cfg(), fft_trace(16, points_per_tile=16))


def _cpu_sim():
    return Simulator(cfg(), fft_trace(16, points_per_tile=16), device="cpu")


@pytest.mark.parametrize("name", ["lane_fetch_cost", "user_mailbox",
                                  "barrier_sync", "lane_commit"])
def test_wrapper_takes_plain_version_for_cpu_tensors(name, monkeypatch):
    sim = _cpu_sim()
    st, ln, p = sim.state, sim._lanes, sim.params
    calls = []
    # the package re-exports each wrapper under its module's name
    mod = importlib.import_module(f"graphite_tpu_torch.ops.{name}")
    plain = getattr(mod, name + "_plain")

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(mod, name + "_plain", spy)
    before = ops.launch_counts()
    qend = torch.tensor(2**61)
    if name == "lane_fetch_cost":
        ops.lane_fetch_cost(sim.device_trace, st.core, st.done,
                            st.models_enabled, qend, sim._cost_table,
                            bp_enabled=True, bp_penalty=14,
                            syscall_rt_ps=2000, lanes=ln)
    elif name == "user_mailbox":
        ops.user_mailbox(p.net, ln, st.core.clock_ps, st.models_enabled,
                         st.net)
    elif name == "barrier_sync":
        ops.barrier_sync(ln, st.core.clock_ps, st.sync)
    else:
        ops.lane_commit(sim.device_trace.op, ln, st.core.freq_mhz,
                        st.models_enabled, st.core, st.net, st.done,
                        st.models_enabled, qend, sim._cost_table,
                        n_follow=15)
    assert calls == [1]
    assert ops.launch_counts() == before


def test_wrappers_refuse_other_devices():
    ln = Lanes.zeros(4, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.barrier_sync(ln, torch.zeros(4, dtype=torch.int64,
                                         device="meta"), None)


@pytest.mark.parametrize("what", [
    "memory", "iocoom", "hop_by_hop", "atac", "statistics_device",
    "power_trace", "stream", "telemetry", "profile", "hist", "dvfs_spec",
    "fft_memory"])
def test_unsupported_configurations_raise(what):
    """Configurations outside the ported slices.  Since MOSI and the
    directory schemes run on the private-L2 engine, "memory" is a trace
    with memory operands under the shared-L2 MSI protocol, "iocoom" the
    iocoom core with memory under the shared-L2 MESI protocol and an
    ackwise directory, "fft_memory" the FFT's loads over a hop-by-hop
    MEMORY net under the shared-L2 MSI, and "hop_by_hop" and "atac" the
    FFT's loads with that net as the USER and the MEMORY net under the
    shared-L2 MESI; since the shared-L2 engine runs too, each of these
    five also asks for trace streaming (item 11), still unported.  Since
    the outputs slice ported lax_p2p and
    barrier_host, their two cases are the statistics manager's
    device-timeline backend ("statistics_device", the telemetry ring)
    and its power trace ("power_trace", runtime energy)."""
    tb = fft_trace(16, points_per_tile=16)
    kw, sc = {}, cfg()
    item = {"memory": 11, "iocoom": 11, "hop_by_hop": 11, "atac": 11,
            "statistics_device": 12, "power_trace": 10, "stream": 11,
            "telemetry": 12, "profile": 12, "hist": 12, "dvfs_spec": 10,
            "fft_memory": 11}[what]
    if what in ("statistics_device", "power_trace"):
        from graphite_tpu_torch.system import StatisticsManager

        extra = ("[statistics_trace]\nenabled = true\n"
                 "statistics = network_utilization\n"
                 if what == "statistics_device" else
                 "[runtime_energy_modeling/power_trace]\nenabled = true\n")
        sim = Simulator(cfg(scheme="lax_barrier", extra=extra), tb,
                        device="cpu")
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            StatisticsManager(sim)
        return
    shl2_msi = "[caching_protocol]\ntype = pr_l1_sh_l2_msi\n"
    shl2_mesi = "[caching_protocol]\ntype = pr_l1_sh_l2_mesi\n"
    if what in ("memory", "iocoom", "fft_memory", "hop_by_hop", "atac"):
        kw = {"stream": True}
    if what == "memory":
        tb.flags[0, 1] = FLAG_MEM0_VALID
        sc = cfg(extra=shl2_msi)
    elif what == "iocoom":
        tb.flags[0, 1] = FLAG_MEM0_VALID
        sc = cfg(extra='[tile]\nmodel_list = "<16, iocoom, T1, T1, T1>"\n'
                 + shl2_mesi + "[dram_directory]\ndirectory_type = ackwise")
    elif what == "fft_memory":
        tb = fft_trace(16, points_per_tile=16, use_memory=True)
        sc = cfg(extra=shl2_msi + "[network]\nmemory = emesh_hop_by_hop")
    elif what in ("hop_by_hop", "atac"):
        net = "emesh_hop_by_hop" if what == "hop_by_hop" else "atac"
        tb = fft_trace(16, points_per_tile=16, use_memory=True)
        sc = cfg(user=net, extra=shl2_mesi + f"[network]\nmemory = {net}")
    elif what == "stream":
        kw = {"stream": True}
    elif what == "dvfs_spec":
        kw = {"dvfs": object()}
    elif what in ("telemetry", "profile", "hist"):
        kw = {what: object()}
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        Simulator(sc, tb, device="cpu", **kw)


# --- semantics pins ---------------------------------------------------------

def test_truncating_modulo_on_negative_operands():
    from graphite_tpu_torch.intmath import nn_div, nn_mod

    x = torch.tensor([-7, -1, 5], dtype=torch.int64)
    assert nn_mod(x, 4).tolist() == [-3, -1, 1]        # lax.rem
    assert (x % 4).tolist() == [1, 3, 1]               # torch floors
    assert nn_div(x, 4).tolist() == [-1, 0, 1]         # lax.div
    assert (x // 4).tolist() == [-2, -1, 1]


def test_pc_is_zero_extended_for_the_predictor():
    b = TraceBuilder().branch(True, pc=0xFFFFFFFF).branch(True,
                                                          pc=0xFFFFFFFF)
    tb = TraceBatch.from_builders([b] + [TraceBuilder() for _ in range(15)])
    sim = Simulator(cfg(extra="[branch_predictor]\nsize = 1000"), tb,
                    device="cpu")
    sim.run()
    # 0xFFFFFFFF mod 1000 = 295 (as int32 it would be -1 -> -1 mod 1000)
    assert int(sim.state.core.bp_bits[0, 295]) == 1
    assert int(sim.state.core.bp_bits[0].sum()) == 1
    assert int(sim.state.core.bp_correct[0]) == 1


def test_elect_min_dump_bucket_and_ties():
    gid = torch.tensor([0, 1, 1, 2, 0])
    key = torch.tensor([5, 3, 3, 9, 1])
    mask = torch.tensor([True, True, True, False, False])
    best = elect_min(mask, gid, key, 3)
    assert best.tolist() == [5, 3, 2**62]
    none = elect_min(torch.zeros(5, dtype=torch.bool), gid, key, 3)
    assert none.tolist() == [2**62] * 3


def test_any_sender_argmin_takes_first_index_on_ties():
    sim = Simulator(cfg(4, user="magic"),
                    synthetic.message_ring_batch(4, 1), device="cpu",
                    mailbox_depth=2)
    st, ln = sim.state, sim._lanes
    st.net.count[0, 1] = st.net.count[0, 3] = st.net.count[0, 2] = 1
    st.net.head[0, 1] = st.net.head[0, 3] = st.net.head[0, 2] = 1
    st.net.time_ps[0, 0, 1] = st.net.time_ps[0, 0, 3] = 700
    st.net.time_ps[0, 0, 2] = 900
    ln.op.fill_(int(Op.NET_RECV))
    ln.aux0.fill_(-1)
    ln.active.copy_(torch.tensor([True, False, False, False]))
    ops.user_mailbox(sim.params.net, ln, st.core.clock_ps,
                     st.models_enabled, st.net)
    assert bool(ln.recv_now[0]) and int(ln.recv_time[0]) == 700
    assert st.net.count[0].tolist() == [0, 0, 1, 1]   # sender 1 popped


def test_duplicate_scatter_adds_accumulate():
    # several tiles arrive at one barrier in one iteration: the arrival
    # count is their sum, the time their max
    sim = Simulator(cfg(4, user="magic"),
                    synthetic.message_ring_batch(4, 1), device="cpu")
    st, ln = sim.state, sim._lanes
    ln.op.fill_(int(Op.BARRIER_WAIT))
    ln.aux0.fill_(0)
    ln.active.fill_(True)
    st.sync.barrier_count[0] = 9
    st.core.clock_ps.copy_(torch.tensor([5, 40, 7, 40]))
    ops.barrier_sync(ln, st.core.clock_ps, st.sync)
    assert int(st.sync.barrier_arrived[0]) == 4
    assert int(st.sync.barrier_time_ps[0]) == 40
    assert not bool(ln.released.any())


def test_int32_head_count_and_latency_wrap():
    sim = Simulator(cfg(4, user="magic"),
                    synthetic.message_ring_batch(4, 1), device="cpu",
                    mailbox_depth=2)
    st, ln = sim.state, sim._lanes
    st.net.head[1, 0] = 2**31 - 1
    ln.op[0] = int(Op.SEND)
    ln.aux0[0] = 1
    ln.active[0] = True
    ops.user_mailbox(sim.params.net, ln, st.core.clock_ps,
                     st.models_enabled, st.net)
    assert int(st.net.head[1, 0]) == -(2**31)
    lat = torch.tensor([2**31 + 5], dtype=torch.int64)
    assert int(lat.to(torch.int32)) == -(2**31) + 5
    np.testing.assert_array_equal(
        np.asarray([2**31 + 5], np.int64).astype(np.int32), [-(2**31) + 5])


def test_package_has_no_jax_imports():
    root = os.path.dirname(graphite_tpu_torch.__file__)
    offenders = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    for line in f:
                        s = line.strip()
                        if s.startswith(("import ", "from ")) and (
                                "jax" in s.split()[1]
                                or s.split()[1].split(".")[0]
                                == "graphite_tpu"):
                            offenders.append((fn, s))
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        for line in f:
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                    "jax" in s.split()[1]
                    or s.split()[1].split(".")[0] == "graphite_tpu"):
                offenders.append(("chip_smoke.py", s))
    assert offenders == []


@pytest.mark.cuda
def test_kernels_equal_plain_versions_on_card():
    """On a CUDA host: every kernel against its plain version over the
    first iterations of a 64-tile FFT (chip_smoke.py does this at full
    width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    sys.path.insert(0, REPO)
    import chip_smoke

    sim = Simulator(cfg(64), fft_trace(64, points_per_tile=64),
                    device="cuda")
    ctx = chip_smoke.Ctx(sim.params, sim.device_trace,
                         chip_smoke.sim_qend(sim), sim._cost_table)
    stats = {k: {"checks": 0, "max_abs_err": 0}
             for k in chip_smoke.KERNEL_ORDER}
    for _ in range(300):
        chip_smoke.checked_iteration(ctx, sim.state, sim._lanes, stats)
    assert all(s["checks"] > 0 and s["max_abs_err"] == 0
               for s in stats.values())
