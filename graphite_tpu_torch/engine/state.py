"""Simulation state: dataclasses of tensors over the tile axis.

Port of `graphite_tpu/engine/state.py`.  Every field keeps the JAX leaf's
dtype and shape, with one deliberate difference on the trace side: the
uint32 `pc` column is ZERO-EXTENDED to int64 on the device (torch has no
uint32 arithmetic worth trusting, and viewing it as int32 would turn high
addresses negative and change `pc mod bp_size`).

Unlike the JAX pytrees these tensors are mutable: the step kernels update
the big mailbox rings, the barrier tables and the per-lane counters in
place instead of producing a new state each iteration (see
`engine/step.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphite_tpu_torch.trace.schema import TraceBatch

# ring depth for per-generation barrier-release / cond-signal times
# (`graphite_tpu/engine/state.py` GEN_RING)
GEN_RING = 8
FAR_FUTURE_PS = 2**62


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


class _TensorTree:
    """`clone()` over a dataclass of tensors (None-safe)."""

    def _map(self, fn):
        out = {}
        for name in _fields(self):
            v = getattr(self, name)
            if isinstance(v, torch.Tensor):
                out[name] = fn(v)
            elif isinstance(v, _TensorTree):
                out[name] = v._map(fn)
            else:
                out[name] = v
        return type(self)(**out)

    def clone(self):
        return self._map(torch.Tensor.clone)


@dataclasses.dataclass
class CoreState(_TensorTree):
    """Per-tile core-model state (`common/tile/core/core_model.h:19-146`)."""

    clock_ps: torch.Tensor           # int64[T]
    idx: torch.Tensor                # int32[T]
    freq_mhz: torch.Tensor           # int32[T]
    instruction_count: torch.Tensor  # int64[T]
    memory_stall_ps: torch.Tensor    # int64[T]
    execution_stall_ps: torch.Tensor  # int64[T]
    recv_instructions: torch.Tensor  # int64[T]
    recv_stall_ps: torch.Tensor      # int64[T]
    sync_instructions: torch.Tensor  # int64[T]
    sync_stall_ps: torch.Tensor      # int64[T]
    bp_bits: torch.Tensor            # uint8[T, bp_size]
    bp_correct: torch.Tensor         # int64[T]
    bp_incorrect: torch.Tensor       # int64[T]


@dataclasses.dataclass
class UserNetState(_TensorTree):
    """The USER network as per-(dst, src) mailbox rings: slot [dst, k, src]
    holds the k-th in-flight packet from src to dst (`state.py:50-70`)."""

    time_ps: torch.Tensor    # int64[T, D, T] — arrival time at receiver
    lat_ps: torch.Tensor     # int32[T, D, T] — zero-load delay (stats)
    head: torch.Tensor       # int32[T, T] — total pushes (mod D write slot)
    count: torch.Tensor      # int32[T, T] — in-flight entries
    overflow: torch.Tensor   # bool[] — any ring exceeded D
    packets_sent: torch.Tensor      # int64[T]
    packets_received: torch.Tensor  # int64[T]
    total_latency_ps: torch.Tensor  # int64[T]


@dataclasses.dataclass
class SyncState(_TensorTree):
    """Simulated sync objects (`common/system/sync_server.h:86-114`)."""

    barrier_count: torch.Tensor      # int32[NB]
    barrier_arrived: torch.Tensor    # int32[NB]
    barrier_time_ps: torch.Tensor    # int64[NB]
    barrier_waiting: torch.Tensor    # bool[T]
    barrier_gen: torch.Tensor        # int32[NB]
    barrier_release_ps: torch.Tensor  # int64[NB, GEN_RING]
    cond_sig_seq: torch.Tensor       # int32[NC]
    cond_sig_seq_ps: torch.Tensor    # int64[NC, GEN_RING]
    mutex_locked: torch.Tensor       # int32[NM]
    mutex_owner: torch.Tensor        # int32[NM]
    mutex_time_ps: torch.Tensor      # int64[NM]
    mutex_waiting: torch.Tensor      # bool[T]
    cond_waiting: torch.Tensor       # bool[T]
    cond_signaled: torch.Tensor      # bool[T]
    cond_arrival_ps: torch.Tensor    # int64[T]
    cond_wake_ps: torch.Tensor       # int64[T]
    cond_sig_time_ps: torch.Tensor   # int64[NC, K]
    cond_bcast_time_ps: torch.Tensor  # int64[NC]


@dataclasses.dataclass
class DvfsState(_TensorTree):
    """Per-tile per-domain frequency/voltage (`dvfs_manager.h:19-88`)."""

    freq_mhz: torch.Tensor     # int32[T, ND]
    voltage_mv: torch.Tensor   # int32[T, ND]
    errors: torch.Tensor       # int64[T]


@dataclasses.dataclass
class SimState(_TensorTree):
    core: CoreState
    net: UserNetState
    sync: SyncState
    models_enabled: torch.Tensor   # bool[]
    done: torch.Tensor             # bool[T]
    dvfs: "DvfsState | None" = None
    p2p_round: "torch.Tensor | None" = None   # int32[]
    mem: "object | None" = None   # memory.state.MemState
    ioc: "object | None" = None   # models.iocoom.IocoomState
    # the USER net's contention queues: models.network_hop_by_hop.NocState
    # under emesh_hop_by_hop, models.network_atac.AtacState under atac
    noc_user: "object | None" = None


@dataclasses.dataclass
class DeviceTrace(_TensorTree):
    """The trace columns the engine reads, [T, L] each, on the device.

    `op`/`flags` stay uint8, `aux0`/`aux1` int32, `dyn_ps` int64; `pc` is
    the uint32 column zero-extended to int64.  The memory-operand columns
    `addr0`/`addr1` (uint32, zero-extended to int64) come to the device
    only for a run with a memory subsystem or the iocoom core, and the
    register columns `rreg0`/`rreg1`/`wreg` (uint16, as int32) only for
    the iocoom core, so the memoryless headline's trace does not grow."""

    op: torch.Tensor
    flags: torch.Tensor
    pc: torch.Tensor
    aux0: torch.Tensor
    aux1: torch.Tensor
    dyn_ps: torch.Tensor
    addr0: "torch.Tensor | None" = None
    addr1: "torch.Tensor | None" = None
    rreg0: "torch.Tensor | None" = None
    rreg1: "torch.Tensor | None" = None
    wreg: "torch.Tensor | None" = None

    @classmethod
    def from_batch(cls, batch: TraceBatch, device, *, addrs: bool = False,
                   regs: bool = False) -> "DeviceTrace":
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dtype=dtype, device=device)

        def zext(a):
            return put(np.asarray(a, np.uint32).astype(np.int64),
                       torch.int64)

        extra = {}
        if addrs:
            extra.update(addr0=zext(batch.addr0), addr1=zext(batch.addr1))
        if regs:
            extra.update({f: put(np.asarray(getattr(batch, f), np.uint16)
                                 .astype(np.int32), torch.int32)
                          for f in ("rreg0", "rreg1", "wreg")})
        return cls(
            op=put(np.asarray(batch.op, np.uint8), torch.uint8),
            flags=put(np.asarray(batch.flags, np.uint8), torch.uint8),
            pc=zext(batch.pc),
            aux0=put(np.asarray(batch.aux0, np.int32), torch.int32),
            aux1=put(np.asarray(batch.aux1, np.int32), torch.int32),
            dyn_ps=put(np.asarray(batch.dyn_ps, np.int64), torch.int64),
            **extra,
        )

    @property
    def length(self) -> int:
        return self.op.shape[1]


@dataclasses.dataclass
class Lanes(_TensorTree):
    """Per-iteration per-lane scratch, allocated once per run and
    overwritten every iteration: what the JAX step carries as local
    values between its units.  `lane_fetch_cost` writes the first block,
    each machinery unit its own outputs (a unit that never runs leaves
    its zeros, which equal the JAX skip branch's outputs wherever they
    are read), and `lane_commit` reads them all."""

    # lane_fetch_cost
    op: torch.Tensor            # int32[T]
    flags: torch.Tensor         # int32[T]
    pc: torch.Tensor            # int64[T] (zero-extended uint32)
    aux0: torch.Tensor          # int32[T]
    aux1: torch.Tensor          # int32[T]
    dyn_ps: torch.Tensor        # int64[T]
    bp_index: torch.Tensor      # int32[T] — pc mod bp_size
    bp_pred: torch.Tensor       # uint8[T]
    done: torch.Tensor          # bool[T] — latched done (this iteration)
    active: torch.Tensor        # bool[T]
    cost_ps: torch.Tensor       # int64[T]
    # noc_route / atac_route: each lane's routed latency (arrival - clock)
    route_lat_ps: torch.Tensor  # int64[T]
    # user_mailbox
    recv_now: torch.Tensor      # bool[T]
    recv_time: torch.Tensor     # int64[T]
    recv_lat: torch.Tensor      # int32[T]
    # barrier_sync
    released: torch.Tensor      # bool[T]
    release_time: torch.Tensor  # int64[T]
    barrive_now: torch.Tensor   # bool[T]
    bsync_now: torch.Tensor     # bool[T]
    bsync_time: torch.Tensor    # int64[T]
    # mutex + cond
    granted: torch.Tensor       # bool[T]
    mutex_wait_ps: torch.Tensor  # int64[T]
    cond_post_commit: torch.Tensor  # bool[T]
    # published signals + COND_JOIN
    pub_now: torch.Tensor       # bool[T]
    cjoin_now: torch.Tensor     # bool[T]
    cjoin_time: torch.Tensor    # int64[T]
    # join
    join_now: torch.Tensor      # bool[T]
    join_time: torch.Tensor     # int64[T]
    # DVFS_SET: the post-retune core frequency
    freq_new: torch.Tensor      # int32[T]
    # models enabled after this iteration's ENABLE/DISABLE events
    en_post: torch.Tensor       # bool[]
    # memory engine: every memory slot of the record complete (all True
    # without a memory subsystem)
    mem_ok: torch.Tensor        # bool[T]
    # iocoom_commit: the committing lanes' clock and stall increments
    ioc_clock: torch.Tensor     # int64[T]
    ioc_mem_stall: torch.Tensor  # int64[T]
    ioc_exec_stall: torch.Tensor  # int64[T]
    # advanced lanes, summed over the current block of iterations
    progress: torch.Tensor      # int32[1]

    @classmethod
    def zeros(cls, n_tiles: int, device) -> "Lanes":
        dtypes = {
            "op": torch.int32, "flags": torch.int32, "pc": torch.int64,
            "aux0": torch.int32, "aux1": torch.int32,
            "dyn_ps": torch.int64, "bp_index": torch.int32,
            "bp_pred": torch.uint8, "recv_lat": torch.int32,
            "freq_new": torch.int32, "ioc_clock": torch.int64,
            "ioc_mem_stall": torch.int64, "ioc_exec_stall": torch.int64,
        }
        out = {}
        for f in dataclasses.fields(cls):
            n = f.name
            if n == "en_post":
                out[n] = torch.zeros((), dtype=torch.bool, device=device)
            elif n == "progress":
                out[n] = torch.zeros(1, dtype=torch.int32, device=device)
            elif n.endswith(("_time", "_ps")):
                out[n] = torch.zeros(n_tiles, dtype=torch.int64,
                                     device=device)
            else:
                out[n] = torch.zeros(n_tiles,
                                     dtype=dtypes.get(n, torch.bool),
                                     device=device)
        out["mem_ok"].fill_(True)
        return cls(**out)


def init_state(
    n_tiles: int,
    *,
    core_freq_mhz: int,
    device,
    bp_size: int = 1024,
    mailbox_depth: int = 8,
    n_barriers: int = 64,
    n_mutexes: int = 64,
    n_conds: int = 64,
    n_pending_signals: int = 4,
    models_enabled: bool = True,
) -> SimState:
    """The zero state (`graphite_tpu/engine/state.py:226`), on `device`."""
    T, D = n_tiles, mailbox_depth
    i64, i32 = torch.int64, torch.int32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    core = CoreState(
        clock_ps=z(T, i64),
        idx=z(T, i32),
        freq_mhz=full((T,), int(core_freq_mhz), i32),
        instruction_count=z(T, i64),
        memory_stall_ps=z(T, i64),
        execution_stall_ps=z(T, i64),
        recv_instructions=z(T, i64),
        recv_stall_ps=z(T, i64),
        sync_instructions=z(T, i64),
        sync_stall_ps=z(T, i64),
        bp_bits=z((T, bp_size), torch.uint8),
        bp_correct=z(T, i64),
        bp_incorrect=z(T, i64),
    )
    net = UserNetState(
        time_ps=z((T, D, T), i64),
        lat_ps=z((T, D, T), i32),
        head=z((T, T), i32),
        count=z((T, T), i32),
        overflow=z((), torch.bool),
        packets_sent=z(T, i64),
        packets_received=z(T, i64),
        total_latency_ps=z(T, i64),
    )
    sync = SyncState(
        barrier_count=z(n_barriers, i32),
        barrier_arrived=z(n_barriers, i32),
        barrier_time_ps=z(n_barriers, i64),
        barrier_waiting=z(T, torch.bool),
        barrier_gen=z(n_barriers, i32),
        barrier_release_ps=z((n_barriers, GEN_RING), i64),
        cond_sig_seq=z(n_conds, i32),
        cond_sig_seq_ps=z((n_conds, GEN_RING), i64),
        mutex_locked=z(n_mutexes, i32),
        mutex_owner=full((n_mutexes,), -1, i32),
        mutex_time_ps=z(n_mutexes, i64),
        mutex_waiting=z(T, torch.bool),
        cond_waiting=z(T, torch.bool),
        cond_signaled=z(T, torch.bool),
        cond_arrival_ps=z(T, i64),
        cond_wake_ps=z(T, i64),
        cond_sig_time_ps=full((n_conds, n_pending_signals), FAR_FUTURE_PS,
                              i64),
        cond_bcast_time_ps=full((n_conds,), FAR_FUTURE_PS, i64),
    )
    return SimState(
        core=core,
        net=net,
        sync=sync,
        models_enabled=torch.tensor(bool(models_enabled), device=device),
        done=z(T, torch.bool),
        p2p_round=z((), i32),
    )
