"""The memory slice's kernel wrappers: their CPU dispatch here, and the
kernels against their plain versions on a card.

 - each of `mem_requester`, `mem_home_start`, `mem_requester_fill` and
   `iocoom_commit` takes its plain version for CPU tensors, and only
   then (no launch is counted);
 - `lane_commit` packs null pointers for the memoryless run's nine
   optional arguments and real ones for a memory + iocoom run;
 - on a CUDA host (marker `cuda`; the kernels have no CPU form): every
   kernel of the companion and of a coherence stress run against its
   plain version, `torch.equal` on every state and lane tensor
   (chip_smoke.py does the same at full length, with edge cases).
"""

import importlib
import os
import sys

import pytest
import torch

from graphite_tpu_torch import ops
from graphite_tpu_torch.config import ConfigFile, SimConfig
from graphite_tpu_torch.config.template import config_text
from graphite_tpu_torch.engine.simulator import Simulator
from graphite_tpu_torch.engine.step import subquantum_iteration
from graphite_tpu_torch.trace.benchmarks import fft_trace
import torch_threads  # noqa: F401  (one intra-op thread)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the module (the package re-exports its wrapper under the same name)
lc = importlib.import_module("graphite_tpu_torch.ops.lane_commit")
NAMES = ("mem_requester", "mem_home_start", "mem_requester_fill",
         "iocoom_commit")


def companion(device, points=32):
    sc = SimConfig(ConfigFile.from_string(config_text(
        64, core="iocoom", shared_mem=True, clock_scheme="lax")))
    return Simulator(sc, fft_trace(64, points_per_tile=points,
                                   use_memory=True), device=device,
                     inner_block=64)


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_takes_plain_version_for_cpu_tensors(name, monkeypatch):
    sim = companion("cpu")
    qend = torch.tensor(2**61)
    for _ in range(140):      # into the loads
        subquantum_iteration(sim.params, sim.device_trace, sim.state, qend,
                             sim._lanes, sim._cost_table, sim.models)
    mod = importlib.import_module(f"graphite_tpu_torch.ops.{name}")
    calls = []
    plain = getattr(mod, name + "_plain")

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(mod, name + "_plain", spy)
    before = ops.launch_counts()
    st, ln, ctx = sim.state, sim._lanes, sim.models.mem
    en, core = st.models_enabled, st.core
    if name == "mem_requester":
        ops.mem_requester(ctx, st.mem, ln, sim.device_trace, core, en,
                          ln.progress)
    elif name == "mem_home_start":
        ops.mem_home_start(ctx, st.mem, en, ln.progress)
    elif name == "mem_requester_fill":
        ops.mem_requester_fill(ctx, st.mem, ln, sim.device_trace, core, en,
                               ln.progress, ln.mem_ok)
    else:
        ops.iocoom_commit(sim.params.iocoom, st.ioc, ln, sim.models.ioc_tile,
                          core, sim.device_trace, st.mem.req.slot_lat_ps, en)
    assert calls == [1]
    assert ops.launch_counts() == before


@pytest.mark.parametrize("run", ["memoryless", "memory_iocoom"])
def test_lane_commit_packs_the_optional_arguments(run):
    """The memoryless run binds nine null pointers (its kernel takes the
    memoryless instantiation); a memory + iocoom run binds them all."""
    if run == "memoryless":
        sim = Simulator(SimConfig(ConfigFile.from_string(config_text(16))),
                        fft_trace(16, points_per_tile=16), device="cpu")
    else:
        sim = companion("cpu")
    st, ln = sim.state, sim._lanes
    req = None if st.mem is None else st.mem.req
    tensors, key = lc.bound_args(
        sim.device_trace.op, ln, st.core.freq_mhz, st.models_enabled,
        st.core, st.net, st.done, st.models_enabled,
        torch.tensor(2**61), sim._cost_table, 0, req, sim.models.ioc_tile)
    block = list(lc._pack(tensors, key))
    optional = block[len(tensors) - 9:len(tensors)]
    if run == "memoryless":
        assert optional == [0] * 9
    else:
        assert optional == [t.data_ptr() for t in tensors[-9:]]
    assert block[len(tensors):] == [st.done.shape[0],
                                    sim.device_trace.length,
                                    st.core.bp_bits.shape[1], 0]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["companion", "memstress"])
def test_memory_kernels_equal_plain_versions_on_card(workload):
    """On a CUDA host: the four memory-slice kernels and the extended
    lane_commit against their plain versions, iteration by iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    sys.path.insert(0, REPO)
    import chip_smoke

    sim = (chip_smoke.companion("cuda", points=64)
           if workload == "companion" else chip_smoke.memstress(64, "cuda"))
    stats = {k: {"checks": 0, "max_abs_err": 0}
             for k in chip_smoke.KERNEL_ORDER + chip_smoke.MEM_KERNELS}
    chip_smoke.run_checked(sim, 300, stats)
    names = ("mem_requester", "mem_home_start", "mem_requester_fill",
             "lane_commit") + (("iocoom_commit",)
                               if workload == "companion" else ())
    assert all(stats[n]["checks"] > 0 and stats[n]["max_abs_err"] == 0
               for n in names)
