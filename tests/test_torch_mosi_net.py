"""MOSI and the directory schemes over the contention MEMORY nets: whole
runs, graphite_tpu_torch (CPU) against graphite_tpu.

MOSI with an ackwise directory (k = 2: sweeps of overflowed entries to
every tile, each copy through the net) and with a limited_no_broadcast
directory (k = 1: displacements, owners flushed out), each under
emesh_hop_by_hop and under atac as the MEMORY net, on the 16-tile
coherence stress trace (shared_fraction 0.5, write_fraction 0.4).  Every
SimResults field, the summary, the line census and `MemState.noc` (every
queue row) must be equal.  Tolerance: zero.
"""

import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.trace import synthetic as j_syn

from graphite_tpu_torch.models.queue_models import COL_REQS

from test_torch_memory import run_both
from test_torch_memory_net import NETS, assert_noc_equal, net_text

MOSI = "[caching_protocol]\ntype = pr_l1_pr_l2_dram_directory_mosi\n"


@pytest.mark.parametrize("scheme,k", [("ackwise", 2),
                                      ("limited_no_broadcast", 1)])
@pytest.mark.parametrize("net", NETS)
def test_mosi_scheme_stress_over_net_equal(net, scheme, k):
    extra = (MOSI + f"[dram_directory]\ndirectory_type = {scheme}\n"
             f"max_hw_sharers = {k}\n")
    batch = j_syn.memory_stress_trace(16, n_accesses=40,
                                      working_set_bytes=1 << 13,
                                      write_fraction=0.4,
                                      shared_fraction=0.5, seed=7)
    jr, tr, js, ts = run_both(net_text(16, net, extra=extra), batch)
    assert tr.func_errors == 0
    assert assert_noc_equal(js, ts)[:, COL_REQS].sum() > 0
    if scheme == "ackwise":
        assert int(tr.mem_counters["dir_broadcasts"].sum()) > 0
