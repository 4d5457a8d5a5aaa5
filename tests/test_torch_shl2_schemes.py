"""The directory schemes on the shared-L2 engine — full_map,
limited_no_broadcast, ackwise, limited_broadcast and limitless over the
L1-sharer lists embedded in the L2 slices — under `pr_l1_sh_l2_msi` and
`_mesi`, whole runs: graphite_tpu_torch (CPU) against graphite_tpu.

tests/test_directory_schemes.py's TestSharedL2Schemes (the ackwise
broadcast, the limited_no_broadcast displacement, the limitless trap on
MESI, MESI at k = 1 where the EXCLUSIVE owner is flushed out) on its
config text, with that test's own assertions held on the port's
results; and each scheme under MSI and MESI on the 16-tile coherence
stress trace (k = 2, a 200-cycle trap).  Every SimResults field, the
summary, the line census, the per-phase skip counts and every state
leaf must be equal.  Tolerance: zero.
"""

import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.trace import synthetic as j_syn

from test_torch_directory_schemes import (
    SCHEMES, sharers_then_write, total,
)
from test_torch_memory import mem_text
from test_torch_shl2 import MESI, MSI, run_shl2


class TestSharedL2Schemes:
    def test_shl2_ackwise_broadcast(self):
        res = sharers_then_write(4, "ackwise", k=2, protocol=MSI)
        assert res.func_errors == 0
        assert total(res, "dir_broadcasts") >= 1

    def test_shl2_limited_no_broadcast(self):
        lim = sharers_then_write(4, "limited_no_broadcast", k=2,
                                 protocol=MSI)
        assert lim.func_errors == 0
        assert total(lim, "invalidations") >= 2
        assert total(lim, "dir_broadcasts") == 0

    def test_shl2_limitless_trap(self):
        full = sharers_then_write(4, "full_map", protocol=MESI)
        lim = sharers_then_write(4, "limitless", k=2, trap=200,
                                 protocol=MESI)
        assert lim.func_errors == 0
        assert lim.completion_time_ps > full.completion_time_ps

    def test_shl2_mesi_capacity_downgrade(self):
        res = sharers_then_write(2, "limited_no_broadcast", k=1,
                                 protocol=MESI)
        assert res.func_errors == 0


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("protocol", [MSI, MESI])
def test_scheme_stress_equal(protocol, scheme):
    extra = (f"[caching_protocol]\ntype = {protocol}\n[dram_directory]\n"
             f"directory_type = {scheme}\nmax_hw_sharers = 2\n"
             "[limitless]\nsoftware_trap_penalty = 200\n")
    batch = j_syn.memory_stress_trace(16, n_accesses=30,
                                      working_set_bytes=1 << 12,
                                      write_fraction=0.4,
                                      shared_fraction=0.6, seed=7)
    _, tr, _, _ = run_shl2(mem_text(16, extra=extra), batch)
    assert tr.func_errors == 0
    if scheme in ("ackwise", "limited_broadcast"):
        assert total(tr, "dir_broadcasts") > 0
