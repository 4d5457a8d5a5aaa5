"""The step's hand-written CUDA kernels, each beside its plain version.

| wrapper            | replaces (graphite_tpu/engine/step.py)            |
| ------------------ | ------------------------------------------------- |
| `lane_fetch_cost`  | fetch :193-241, done/active :242-251, cost :342-403 |
|   `[p2p]`          | the same, with the `lax_p2p` hold :253-272        |
| `user_mailbox`     | `_net_block` :413-502 (+ network_user.py:96-116)  |
| `noc_route`        | `_net_block` :414-423 (+ network_hop_by_hop.py)   |
| `atac_route`       | `_net_block` :424-431 (+ network_atac.py)         |
| `barrier_sync`     | `_barrier_block` :505-577, `_elect_min` :136-146   |
| `lane_commit`      | commit :842-915/:1098-1140, batching :999-1066    |

| wrapper              | replaces (graphite_tpu/)                         |
| -------------------- | ------------------------------------------------ |
| `mem_requester`      | memory/engine.py `_requester_once` :1378-1688    |
| `mem_home_start`     | memory/engine.py `_home_starts` :2219-2546       |
|   `[ext]`            | the same under MOSI or a limited scheme          |
| `mem_requester_fill` | memory/engine.py `_requester_fill` :2547-2712    |
| `iocoom_commit`      | models/iocoom.py `iocoom_commit` :129-330        |
| `mem_net_route`      | memory/engine.py `mem_net_send` :251-277 (phases 4-5) |
| `shl2_requester`     | memory/engine_shl2.py `_phase_requester` :407-521 |
| `shl2_home_start`    | memory/engine_shl2.py `_home_starts` :933-1138   |
| `shl2_requester_fill` | memory/engine_shl2.py `_requester_fill` :1141-1230 |

Each wrapper runs its `*_plain` PyTorch version for CPU tensors and
launches its kernel (`csrc/<name>.cu`) for CUDA tensors, or raises; it
never falls back from the kernel to the plain version; every kernel
launches through its binding (`build.Kernel.launch_bound`).  `KERNELS`
maps each name to its `build.Kernel`, whose `launches` counts kernel
launches and `packs` the argument sets it validated.
"""

from graphite_tpu_torch.ops import (
    atac_route as _atac_route,
    barrier_sync as _barrier_sync,
    iocoom_commit as _iocoom_commit,
    lane_commit as _lane_commit,
    lane_fetch_cost as _lane_fetch_cost,
    mem_home_start as _mem_home_start,
    mem_net_route as _mem_net_route,
    mem_requester as _mem_requester,
    mem_requester_fill as _mem_requester_fill,
    noc_route as _noc_route,
    shl2_home_start as _shl2_home_start,
    shl2_requester as _shl2_requester,
    shl2_requester_fill as _shl2_requester_fill,
    user_mailbox as _user_mailbox,
)
from graphite_tpu_torch.ops.atac_route import atac_route, atac_route_plain
from graphite_tpu_torch.ops.barrier_sync import barrier_sync, barrier_sync_plain
from graphite_tpu_torch.ops.iocoom_commit import (
    iocoom_commit, iocoom_commit_plain,
)
from graphite_tpu_torch.ops.lane_commit import lane_commit, lane_commit_plain
from graphite_tpu_torch.ops.lane_fetch_cost import (
    lane_fetch_cost, lane_fetch_cost_plain,
)
from graphite_tpu_torch.ops.mem_home_start import (
    mem_home_start, mem_home_start_plain,
)
from graphite_tpu_torch.ops.mem_net_route import (
    mem_net_route, mem_net_route_plain,
)
from graphite_tpu_torch.ops.mem_requester import (
    mem_requester, mem_requester_plain,
)
from graphite_tpu_torch.ops.mem_requester_fill import (
    mem_requester_fill, mem_requester_fill_plain,
)
from graphite_tpu_torch.ops.noc_route import noc_route, noc_route_plain
from graphite_tpu_torch.ops.shl2_home_start import (
    shl2_home_start, shl2_home_start_plain,
)
from graphite_tpu_torch.ops.shl2_requester import (
    shl2_requester, shl2_requester_plain,
)
from graphite_tpu_torch.ops.shl2_requester_fill import (
    shl2_requester_fill, shl2_requester_fill_plain,
)
from graphite_tpu_torch.ops.user_mailbox import user_mailbox, user_mailbox_plain

KERNELS = {
    m.KERNEL.name: m.KERNEL
    for m in (_lane_fetch_cost, _user_mailbox, _barrier_sync, _lane_commit,
              _mem_requester, _mem_home_start, _mem_requester_fill,
              _iocoom_commit, _noc_route, _atac_route, _mem_net_route,
              _shl2_requester, _shl2_home_start, _shl2_requester_fill)
}
# the `lax_p2p` instantiation of lane_fetch_cost and the MOSI / scheme
# instantiation of mem_home_start, counted apart
for _k in (_lane_fetch_cost.KERNEL_P2P, _mem_home_start.KERNEL_EXT):
    KERNELS[_k.name] = _k
del _k


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def pack_counts() -> dict:
    return {name: k.packs for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's `launches` and `packs` to 0."""
    for k in KERNELS.values():
        k.launches = 0
        k.packs = 0


__all__ = [
    "KERNELS", "atac_route", "atac_route_plain", "barrier_sync", "barrier_sync_plain", "iocoom_commit",
    "iocoom_commit_plain", "lane_commit", "lane_commit_plain",
    "lane_fetch_cost", "lane_fetch_cost_plain", "launch_counts",
    "mem_home_start", "mem_home_start_plain", "mem_net_route",
    "mem_net_route_plain", "mem_requester",
    "mem_requester_fill", "mem_requester_fill_plain", "mem_requester_plain",
    "noc_route", "noc_route_plain", "pack_counts", "reset_launch_counts",
    "shl2_home_start", "shl2_home_start_plain", "shl2_requester",
    "shl2_requester_fill", "shl2_requester_fill_plain",
    "shl2_requester_plain", "user_mailbox", "user_mailbox_plain",
]
