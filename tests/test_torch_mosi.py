"""The MOSI protocol (`pr_l1_pr_l2_dram_directory_mosi`), whole runs:
graphite_tpu_torch (CPU) against graphite_tpu and the golden memory
model.

Every scenario of tests/test_mosi.py on its config text (the owner keeps
a read line dirty in O with no DRAM write, reads of SHARED / OWNED lines
fetched cache-to-cache, the EX sweep over an OWNED line, the OWNED
upgrade by the owner, capacity evictions that flush OWNED lines, the
single-tile MSI equivalence), with that test's own assertions held on
the port's results; the MOSI cases of tests/test_memory_golden.py (their
builders imported from that module), where the port is held to
`golden/memory_model.py` as the JAX engine is; and the 64-tile iocoom
companion's config under MOSI at 16 tiles.  Every SimResults field
(`mem_counters` with `dir_broadcasts`, `func_errors`), `n_quanta`,
`last_n_iterations`, the summary and the line census must be equal.
Tolerance: zero (integer picoseconds and counts).
"""

import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.trace.benchmarks import fft_trace as j_fft
from graphite_tpu.trace.schema import TraceBatch, TraceBuilder

from graphite_tpu_torch.config.template import config_text

from test_torch_memory import GOLDEN_CASES, assert_golden, mem_text, run_both

MSI = "pr_l1_pr_l2_dram_directory_msi"
MOSI = "pr_l1_pr_l2_dram_directory_mosi"


def mosi_text(n_tiles, protocol=MOSI):
    """tests/test_mosi.py's make_config."""
    return f"""
[general]
total_cores = {n_tiles}
mode = lite
max_frequency = 1.0
enable_shared_mem = true

[caching_protocol]
type = {protocol}
[network]
user = magic
memory = magic
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
[clock_skew_management]
scheme = lax_barrier
[clock_skew_management/lax_barrier]
quantum = 1000
"""


def batch(builders):
    return TraceBatch.from_builders(builders)


def producer_consumer():
    b0 = TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x0, 42)
    b0.barrier_wait(0)
    b1 = TraceBuilder()
    b1.barrier_wait(0)
    b1.load_check(0x0, 42)
    return batch([b0, b1])


def second_reader():
    bs = [TraceBuilder() for _ in range(4)]
    bs[0].barrier_init(0, 4)
    bs[0].store_value(0x0, 7)
    for t, b in enumerate(bs):
        b.barrier_wait(0)
        if t == 1:
            b.load_check(0x0, 7)
        b.barrier_wait(0)
        if t == 2:
            b.load_check(0x0, 7)
    return batch(bs)


def write_after_read_sharing():
    bs = [TraceBuilder() for _ in range(3)]
    bs[0].barrier_init(0, 3)
    bs[0].store_value(0x40, 1)              # tile 0: M
    for t, b in enumerate(bs):
        b.barrier_wait(0)
        if t == 1:
            b.load_check(0x40, 1)           # tile 0 M -> O, tile 1 S
        b.barrier_wait(0)
        if t == 2:
            b.store_value(0x40, 9)          # EX on OWNED
        b.barrier_wait(0)
    bs[0].load_check(0x40, 9)
    return batch(bs)


def ping_pong():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x40, 1)
    b0.barrier_wait(0)
    b0.barrier_wait(0)
    b0.load_check(0x40, 2)
    b1.barrier_wait(0)
    b1.store_value(0x40, 2)
    b1.barrier_wait(0)
    return batch([b0, b1])


def owned_upgrade_by_sharer():
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x0, 5)                  # tile 0: M
    b0.barrier_wait(0)
    b0.barrier_wait(0)
    b0.load_check(0x0, 6)
    b1.barrier_wait(0)
    b1.load_check(0x0, 5)                   # tile 0 -> O, tile 1 -> S
    b1.store_value(0x0, 6)                  # the sharer upgrades
    b1.barrier_wait(0)
    return batch([b0, b1])


def owned_upgrade_by_owner():
    """The owner of an OWNED line writes it again: its upgrade's eviction
    is a FLUSH (the dirty line), the OWNED upgrade of the requester
    phase."""
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    b0.store_value(0x0, 5)                  # tile 0: M
    b0.barrier_wait(0)
    b0.barrier_wait(0)
    b0.store_value(0x0, 8)                  # tile 0 in O upgrades
    b0.barrier_wait(0)
    b1.barrier_wait(0)
    b1.load_check(0x0, 5)                   # tile 0 -> O, tile 1 -> S
    b1.barrier_wait(0)
    b1.barrier_wait(0)
    b1.load_check(0x0, 8)
    return batch([b0, b1])


def capacity_evictions_flush_owned():
    n_lines = 64
    b0, b1 = TraceBuilder(), TraceBuilder()
    b0.barrier_init(0, 2)
    for i in range(n_lines):
        b0.store_value(i * 64, i)           # tile 0 owns n dirty lines
    b0.barrier_wait(0)
    b0.barrier_wait(0)
    b1.barrier_wait(0)
    for i in range(n_lines):
        b1.load_check(i * 64, i)            # all M -> O
    for i in range(n_lines):
        b1.store_value(0x100000 + i * 64, i)
    b1.barrier_wait(0)
    return batch([b0, b1])


def single_tile():
    b = TraceBuilder()
    b.store_value(0x80, 3)
    b.load_check(0x80, 3)
    return batch([b])


SCENARIOS = {
    "producer_consumer_no_dram_write": (2, producer_consumer),
    "second_reader_served_cache_to_cache": (4, second_reader),
    "write_after_read_sharing_invalidates_owner": (
        3, write_after_read_sharing),
    "ping_pong_alternating_writers": (2, ping_pong),
    "owned_upgrade_by_sharer": (2, owned_upgrade_by_sharer),
    "owned_upgrade_by_owner": (2, owned_upgrade_by_owner),
    "capacity_evictions_flush_owned": (2, capacity_evictions_flush_owned),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_mosi_scenario_equal(case):
    """tests/test_mosi.py's scenarios, port against JAX, and the JAX
    test's assertions on the port's results."""
    n, build = SCENARIOS[case]
    jr, tr, _, _ = run_both(mosi_text(n), build())
    assert tr.func_errors == 0
    mc = tr.mem_counters
    if case == "producer_consumer_no_dram_write":
        assert mc["l1d_read_misses"][1] == 1
        assert mc["dram_writes"].sum() == 0      # MSI would write back
        assert mc["dram_reads"].sum() == 1
    elif case == "second_reader_served_cache_to_cache":
        assert mc["dram_reads"].sum() == 1       # only the cold fill
        assert mc["dram_writes"].sum() == 0
    elif case == "write_after_read_sharing_invalidates_owner":
        assert mc["invalidations"].sum() >= 1
        assert mc["dram_reads"].sum() == 1
    elif case == "owned_upgrade_by_owner":
        # the owner's FLUSH of its OWNED line parks the data at the home:
        # the upgrade's refetch reads no DRAM
        assert mc["dram_reads"].sum() == 1
        assert mc["evictions"].sum() >= 1


def test_single_tile_msi_equivalence():
    """With one tile and no sharing, MOSI timing equals MSI's, in both
    packages."""
    _, mosi, _, _ = run_both(mosi_text(1), single_tile())
    _, msi, _, _ = run_both(mosi_text(1, MSI), single_tile())
    assert mosi.clock_ps[0] == msi.clock_ps[0]
    assert mosi.func_errors == 0


# tests/test_memory_golden.py's cases that it runs under MOSI too
GOLDEN_MOSI = ("single_tile_random", "disjoint_working_sets",
               "mutex_serialized_sharing", "wb_downgrade",
               "nullify_tiny_directory", "miss_types", "line_utilization")


@pytest.mark.parametrize("case", GOLDEN_MOSI)
def test_golden_workload_equal_mosi(case):
    n, net, extra, build, _ = GOLDEN_CASES[case]
    text = mem_text(n, net, extra).replace(MSI, MOSI)
    b = build()
    jr, tr, _, _ = run_both(text, b)
    assert int(tr.mem_counters["l2_misses"].sum()) > 0
    assert_golden(text, b, tr)


def test_iocoom_companion_config_mosi():
    """bench.py's coherence companion config (iocoom, emesh_hop_counter,
    lax) under MOSI, at 16 tiles: the FFT's loads."""
    text = config_text(16, core="iocoom", shared_mem=True,
                       clock_scheme="lax", protocol=MOSI)
    jr, tr, _, _ = run_both(text, j_fft(16, 32, use_memory=True),
                            census=False, inner_block=64)
    assert tr.detailed_stalls is not None
    assert int(tr.mem_counters["l2_misses"].sum()) > 0
