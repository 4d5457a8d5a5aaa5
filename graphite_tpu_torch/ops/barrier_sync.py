"""`barrier_sync`: barrier init, arrival, release and the split forms.

Replaces `_barrier_block` (`graphite_tpu/engine/step.py:505-577`) with its
`_elect_min` init election (`:136-146`).  Kernel: `csrc/barrier_sync.cu`,
one CTA, one lane a thread (a stride loop above 1024 lanes), which skips
the block on the device when no lane is at a barrier op; launched
through a binding (`build.Kernel.launch_bound`): its arguments are
validated once per set of tensors, not on every call.

Semantics (both versions, updating the barrier tables in place; bar =
clip(aux0, 0, NB-1)):
 - BARRIER_INIT: per barrier, the lowest active initializing tile wins
   and sets count = aux1 (several tiles may init one barrier at once);
 - arrivals (active BARRIER_WAIT not yet waiting, or BARRIER_ARRIVE) add
   one to `arrived` and max their clock into `time` (non-arrivals max 0
   into barrier 0, as the JAX scatter does);
 - a barrier releases when count > 0 and arrived >= count: its waiting
   participants are released at its max arrival time, its generation
   counter steps, the generation ring records the release time, and its
   arrived/time reset to 0;
 - BARRIER_SYNC(aux1) completes once the barrier's generation >= aux1,
   at the release time of generation aux1 mod GEN_RING (floor mod).
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.engine.state import GEN_RING, Lanes, SyncState
from graphite_tpu_torch.ops.build import Kernel, check_width, pack_args
from graphite_tpu_torch.trace.schema import Op

BIG = 2**62
# the kernel stages the barrier tables in shared memory (32 B a barrier)
# and runs one CTA of at most 1024 threads
MAX_BARRIERS = 1024


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`BarrierArgs` in
    csrc/barrier_sync.cu: the 17 pointers, then T and NB).  No plain
    value: `key` is empty."""
    if key:
        raise ValueError(f"barrier_sync: unexpected key {key}")
    T = tensors[0].shape[0]
    NB = tensors[6].shape[0]
    check_width("barrier_sync", NB, MAX_BARRIERS, "barriers")
    i32, i64, b = torch.int32, torch.int64, torch.bool
    t, nb = (T,), (NB,)
    specs = (("lanes.op", i32, t), ("lanes.aux0", i32, t),
             ("lanes.aux1", i32, t), ("lanes.active", b, t),
             ("lanes.done", b, t), ("clock_ps", i64, t),
             ("barrier_count", i32, nb), ("barrier_arrived", i32, nb),
             ("barrier_time_ps", i64, nb), ("barrier_waiting", b, t),
             ("barrier_gen", i32, nb),
             ("barrier_release_ps", i64, (NB, GEN_RING)),
             ("lanes.released", b, t), ("lanes.release_time", i64, t),
             ("lanes.barrive_now", b, t), ("lanes.bsync_now", b, t),
             ("lanes.bsync_time", i64, t))
    return pack_args(tensors, specs, (T, NB))


KERNEL = Kernel("barrier_sync", "gt_barrier_sync", pack=_pack)


def elect_min(mask: torch.Tensor, gid: torch.Tensor, key: torch.Tensor,
              n_groups: int) -> torch.Tensor:
    """Per-group minimum of `key` over lanes with `mask` (`step.py:136`):
    a scatter-min into n_groups + 1 buckets, the last one collecting the
    masked-off lanes.  Empty groups hold 2**62."""
    best = torch.full((n_groups + 1,), BIG, dtype=torch.int64,
                      device=key.device)
    best.scatter_reduce_(0, torch.where(mask, gid, n_groups).to(torch.int64),
                         torch.where(mask, key, BIG), "amin",
                         include_self=True)
    return best[:n_groups]


def barrier_sync_plain(lanes: Lanes, clock: torch.Tensor,
                       sync: SyncState) -> None:
    NB = sync.barrier_count.shape[0]
    T = clock.shape[0]
    op, aux1, active = lanes.op, lanes.aux1, lanes.active
    tiles = torch.arange(T, dtype=torch.int64, device=clock.device)
    bar = torch.clamp(lanes.aux0, 0, NB - 1).to(torch.int64)
    is_bwait = op == Op.BARRIER_WAIT

    binit_now = active & (op == Op.BARRIER_INIT)
    init_best = elect_min(binit_now, bar, tiles, NB)
    init_win = binit_now & (tiles == init_best[bar])
    count = sync.barrier_count.scatter_add(0, bar, torch.where(
        init_win, aux1 - sync.barrier_count[bar], 0).to(torch.int32))

    arrive_only = active & (op == Op.BARRIER_ARRIVE)
    new_arrival = (active & is_bwait & ~sync.barrier_waiting) | arrive_only
    arr_tgt = torch.where(new_arrival, bar, 0)
    arrived = sync.barrier_arrived.scatter_add(
        0, arr_tgt, new_arrival.to(torch.int32))
    btime = sync.barrier_time_ps.scatter_reduce(
        0, arr_tgt, torch.where(new_arrival, clock, 0), "amax",
        include_self=True)
    release_bar = (count > 0) & (arrived >= count)
    participant = is_bwait & (sync.barrier_waiting | new_arrival) & ~lanes.done
    released = participant & release_bar[bar]
    release_time = btime[bar]
    waiting = (sync.barrier_waiting | (new_arrival & ~arrive_only)) & ~released

    gen = sync.barrier_gen + release_bar.to(torch.int32)
    slot = torch.fmod(gen, GEN_RING).to(torch.int64)
    rows = torch.arange(NB, device=clock.device)
    ring = sync.barrier_release_ps
    ring[rows, slot] = torch.where(release_bar, btime, ring[rows, slot])
    bsync_now = active & (op == Op.BARRIER_SYNC) & (gen[bar] >= aux1)
    bsync_time = ring[bar, torch.remainder(aux1, GEN_RING).to(torch.int64)]

    sync.barrier_count.copy_(count)
    sync.barrier_arrived.copy_(torch.where(release_bar, 0, arrived))
    sync.barrier_time_ps.copy_(torch.where(release_bar, 0, btime))
    sync.barrier_waiting.copy_(waiting)
    sync.barrier_gen.copy_(gen)
    lanes.released.copy_(released)
    lanes.release_time.copy_(release_time)
    lanes.barrive_now.copy_(arrive_only)
    lanes.bsync_now.copy_(bsync_now)
    lanes.bsync_time.copy_(bsync_time)


def barrier_sync(lanes: Lanes, clock: torch.Tensor, sync: SyncState) -> None:
    """One iteration of the barrier machinery; updates `sync`'s barrier
    tables in place and writes the `lanes` barrier outputs."""
    if clock.device.type == "cpu":
        barrier_sync_plain(lanes, clock, sync)
        return
    if clock.device.type != "cuda":
        raise ValueError(f"barrier_sync: unsupported device {clock.device}")
    KERNEL.launch_bound(*bound_args(lanes, clock, sync))


def bound_args(lanes: Lanes, clock: torch.Tensor, sync: SyncState) -> tuple:
    """The (tensors, key) a call binds, in `BarrierArgs` order."""
    return ((lanes.op, lanes.aux0, lanes.aux1, lanes.active, lanes.done,
             clock, sync.barrier_count, sync.barrier_arrived,
             sync.barrier_time_ps, sync.barrier_waiting, sync.barrier_gen,
             sync.barrier_release_ps, lanes.released, lanes.release_time,
             lanes.barrive_now, lanes.bsync_now, lanes.bsync_time), ())
