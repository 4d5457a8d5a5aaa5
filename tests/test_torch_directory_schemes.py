"""The directory schemes on the private-L2 engine — limited_no_broadcast,
ackwise, limited_broadcast, limitless and full_map — under MSI and MOSI,
whole runs: graphite_tpu_torch (CPU) against graphite_tpu and the golden
memory model.

Every scenario of tests/test_directory_schemes.py's private-L2 classes
(TestLimitedNoBroadcast, TestAckwise, TestLimitless,
TestFullMapUnchanged) on its config text, with that test's own
assertions held on the port's results (each config run once a module,
shared by the tests that read it); and test_memory_golden.py's
`test_directory_scheme` cases (each scheme under MSI and MOSI), where the
port is held to `golden/memory_model.py` as the JAX engine is.  Every
SimResults field (`mem_counters` with `dir_broadcasts`, `func_errors`),
`n_quanta`, `last_n_iterations`, the summary and the line census must be
equal.  Tolerance: zero.  TestSharedL2Schemes waits for the shared-L2
engine (ROADMAP.md queue 1, item 8).
"""

import functools
import os
import sys

import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.trace.schema import TraceBatch, TraceBuilder

from test_memory_golden import share_then_write
from test_torch_memory import assert_golden, mem_text, run_both

MSI = "pr_l1_pr_l2_dram_directory_msi"
MOSI = "pr_l1_pr_l2_dram_directory_mosi"
SCHEMES = ("full_map", "limited_no_broadcast", "ackwise",
           "limited_broadcast", "limitless")


def scheme_text(n_tiles, dir_type, k=2, trap=200, protocol=None):
    """tests/test_directory_schemes.py's make_config (with its
    `caching_protocol/type` override)."""
    proto = f"[caching_protocol]\ntype = {protocol}\n" if protocol else ""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
enable_shared_mem = true
[network]
user = magic
memory = magic
[dram_directory]
directory_type = {dir_type}
max_hw_sharers = {k}
[limitless]
software_trap_penalty = {trap}
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
[branch_predictor]
type = one_bit
mispredict_penalty = 14
size = 1024
[clock_skew_management]
scheme = lax_barrier
[clock_skew_management/lax_barrier]
quantum = 1000
{proto}"""


def sharers_then_write_batch(n_tiles):
    """All tiles read one line (n sharers), then tile 0 writes it (EX)."""
    builders = []
    for t in range(n_tiles):
        b = TraceBuilder()
        if t == 0:
            b.barrier_init(0, n_tiles)
        b.load_check(0x100, 0)
        b.barrier_wait(0)
        if t == 0:
            b.store_value(0x100, 9)
        b.barrier_wait(0)
        if t != 0:
            b.load_check(0x100, 9)
        builders.append(b)
    return TraceBatch.from_builders(builders)


def modified_to_shared_batch():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x200, 77)       # M at tile 0
    b0.barrier_wait(0)
    b0.barrier_wait(0)
    b0.load_check(0x200, 77)        # refetch after being flushed out
    b1.barrier_wait(0)
    b1.load_check(0x200, 77)        # SH displaces the M owner
    b1.barrier_wait(0)
    return TraceBatch.from_builders([b0, b1])


@functools.lru_cache(maxsize=None)
def sharers_then_write(n_tiles, dir_type, k=2, trap=200, protocol=None):
    """The port's results of `run_sharers_then_write`, held equal to the
    JAX package's (one run a config a module)."""
    _, tr, _, _ = run_both(scheme_text(n_tiles, dir_type, k, trap, protocol),
                           sharers_then_write_batch(n_tiles))
    return tr


def total(res, name):
    return int(res.mem_counters[name].sum())


class TestLimitedNoBroadcast:
    def test_displacement_invalidation(self):
        full = sharers_then_write(4, "full_map")
        lim = sharers_then_write(4, "limited_no_broadcast", k=2)
        assert full.func_errors == 0 and lim.func_errors == 0
        assert total(lim, "invalidations") >= 2
        assert total(lim, "dir_broadcasts") == 0

    def test_functional_correctness_many_tiles(self):
        assert sharers_then_write(8, "limited_no_broadcast", k=1
                                  ).func_errors == 0

    def test_modified_to_shared_at_capacity(self):
        _, res, _, _ = run_both(scheme_text(2, "limited_no_broadcast", k=1),
                                modified_to_shared_batch())
        assert res.func_errors == 0
        # tile 0 lost its copy to the FLUSH: its later read misses L1D
        assert res.mem_counters["l1d_read_misses"][0] >= 1

    def test_mosi_displacement(self):
        assert sharers_then_write(6, "limited_no_broadcast", k=2,
                                  protocol=MOSI).func_errors == 0


class TestAckwise:
    def test_broadcast_on_overflow(self):
        res = sharers_then_write(4, "ackwise", k=2)
        assert res.func_errors == 0
        assert total(res, "dir_broadcasts") >= 1

    def test_no_broadcast_below_capacity(self):
        res = sharers_then_write(4, "ackwise", k=8)
        assert res.func_errors == 0
        assert total(res, "dir_broadcasts") == 0

    def test_limited_broadcast_same_model(self):
        res = sharers_then_write(4, "limited_broadcast", k=2)
        assert res.func_errors == 0
        assert total(res, "dir_broadcasts") >= 1

    def test_timing_matches_full_map_zero_contention(self):
        full = sharers_then_write(4, "full_map")
        ack = sharers_then_write(4, "ackwise", k=2)
        assert ack.completion_time_ps == full.completion_time_ps


class TestLimitless:
    def test_software_trap_latency(self):
        full = sharers_then_write(4, "full_map")
        lim = sharers_then_write(4, "limitless", k=2, trap=200)
        assert lim.func_errors == 0
        assert lim.completion_time_ps > full.completion_time_ps
        assert (lim.completion_time_ps - full.completion_time_ps) >= 200_000

    def test_no_trap_below_capacity(self):
        full = sharers_then_write(4, "full_map")
        lim = sharers_then_write(4, "limitless", k=64, trap=200)
        assert lim.completion_time_ps == full.completion_time_ps


class TestFullMapUnchanged:
    @pytest.mark.parametrize("scheme", ["full_map", "ackwise", "limitless"])
    def test_mosi_all_schemes_functional(self, scheme):
        assert sharers_then_write(4, scheme, k=2, protocol=MOSI
                                  ).func_errors == 0


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("proto", [MSI, MOSI])
def test_golden_directory_scheme(scheme, proto):
    """test_memory_golden.py's test_directory_scheme: share_then_write on
    4 tiles, k = 2, a 200-cycle trap."""
    extra = (f"[dram_directory]\ndirectory_type = {scheme}\n"
             "max_hw_sharers = 2\n[limitless]\n"
             "software_trap_penalty = 200\n")
    text = mem_text(4, extra=extra).replace(MSI, proto)
    batch = share_then_write(4)
    _, tr, _, _ = run_both(text, batch)
    assert_golden(text, batch, tr)
    if scheme in ("ackwise", "limited_broadcast"):
        assert total(tr, "dir_broadcasts") > 0


def test_unknown_directory_type_raises():
    """A directory type the reference does not have is refused (the JAX
    package would run it as full_map)."""
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace.synthetic import memory_stress_trace

    sc = SimConfig(ConfigFile.from_string(scheme_text(4, "fullmap")))
    with pytest.raises(ValueError, match="directory_type"):
        Simulator(sc, memory_stress_trace(4, n_accesses=5), device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("proto", [MSI, MOSI])
def test_home_start_entry_point(scheme, proto):
    """Phase 3 launches `mem_home_start` under MSI full_map only, and its
    second entry point `mem_home_start[ext]` (one library, counted
    apart) under MOSI or a limited scheme; `SCHEMES` is the kernels'
    order."""
    from graphite_tpu_torch import ops
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.memory.params import SCHEMES as PORT_SCHEMES
    from graphite_tpu_torch.ops.mem_home_start import kernel_for
    from graphite_tpu_torch.trace.synthetic import memory_stress_trace

    assert PORT_SCHEMES == SCHEMES
    sc = SimConfig(ConfigFile.from_string(scheme_text(4, scheme,
                                                      protocol=proto)))
    sim = Simulator(sc, memory_stress_trace(4, n_accesses=5), device="cpu")
    k = kernel_for(sim.models.mem)
    ext = proto == MOSI or scheme != "full_map"
    assert k.name == ("mem_home_start[ext]" if ext else "mem_home_start")
    assert ops.KERNELS[k.name] is k
    assert k.source.endswith("csrc/mem_home_start.cu")
    # chip_smoke.py counts its checks under the same name
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.mem_stat_key("mem_home_start", sim) == k.name
    assert chip_smoke.mem_stat_key("mem_requester", sim) == "mem_requester"
