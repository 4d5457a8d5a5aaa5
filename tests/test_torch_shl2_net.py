"""The shared-L2 engine over the contention MEMORY nets: whole runs,
graphite_tpu_torch (CPU) against graphite_tpu and the golden shared-L2
model.

tests/test_memory_net.py's shared-L2 cases: the 8-tile stress run under
the hop counter and under emesh_hop_by_hop (the contention shows:
hop-by-hop ends later); mutex-serialized RMWs at 16 tiles over atac
(bit-exact against `golden/memory_model_shl2.py` there too); the ackwise
broadcast row over atac (held to the golden model, broadcasts counted).
Every SimResults field, the summary, the line census, the per-phase
skip counts, every state leaf and `ShL2State.noc` (every queue row) must
be equal.  Tolerance: zero.
"""

import numpy as np
import pytest

import graphite_tpu  # noqa: F401  (x64)
from graphite_tpu.trace import synthetic as j_syn
from graphite_tpu.trace.schema import TraceBatch, TraceBuilder

from graphite_tpu_torch.models.queue_models import COL_REQS

from test_memory_golden import mutex_rmw
from test_torch_memory import assert_golden
from test_torch_memory_net import assert_noc_equal, net_text
from test_torch_shl2 import MSI, run_shl2


SHL2 = f"[caching_protocol]\ntype = {MSI}\n"


@pytest.mark.parametrize("net", ["emesh_hop_counter", "emesh_hop_by_hop"])
def test_hbh_stress_runs_equal(net):
    batch = j_syn.memory_stress_trace(
        8, n_accesses=40, working_set_bytes=1 << 12,
        write_fraction=0.4, shared_fraction=0.5, seed=2)
    text = net_text(8, net, extra=SHL2)
    _, tr, js, ts = run_shl2(text, batch)
    assert tr.func_errors == 0
    if net == "emesh_hop_by_hop":
        assert assert_noc_equal(js, ts)[:, COL_REQS].sum() > 0
        zl = run_shl2(net_text(8, "emesh_hop_counter", extra=SHL2),
                      batch)[1]
        assert tr.completion_time_ps > zl.completion_time_ps


def _ackwise_batch():
    bs = [TraceBuilder() for _ in range(16)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(9, 16)
    for b in bs:
        b.barrier_wait(9)
    for b in bs:
        b.mutex_lock(0)
        b.load(0x900000, 8)
        b.mutex_unlock(0)
    for b in bs:
        b.barrier_wait(9)
    bs[10].mutex_lock(0)
    bs[10].store(0x900000, 8)
    bs[10].mutex_unlock(0)
    for b in bs:
        b.barrier_wait(9)
    for t in (1, 5, 10, 15):
        bs[t].mutex_lock(0)
        bs[t].load(0x900000 + 64, 8)
        bs[t].mutex_unlock(0)
    return TraceBatch.from_builders(bs)


@pytest.mark.parametrize("case", ["serialized", "ackwise_broadcast"])
def test_atac_exact(case):
    extra = SHL2
    if case == "ackwise_broadcast":
        extra += "[dram_directory]\ndirectory_type = ackwise\n" \
                 "max_hw_sharers = 2\n"
        batch = _ackwise_batch()
    else:
        batch = mutex_rmw(16, rounds=3, lines=2)
    text = net_text(16, "atac", extra=extra)
    _, tr, js, ts = run_shl2(text, batch)
    assert_golden(text, batch, tr)
    assert assert_noc_equal(js, ts)[:, COL_REQS].sum() > 0
    if case == "ackwise_broadcast":
        assert int(np.asarray(tr.mem_counters["dir_broadcasts"]).sum()) > 0
    else:
        assert int(np.asarray(tr.mem_counters["l2_misses"]).sum()) > 0
