"""The IOCOOM core model (in-order commit, out-of-order memory): state.

Port of `graphite_tpu/models/iocoom.py` (`IocoomParams`, `IocoomState`,
`init_iocoom_state`; reference `iocoom_core_model.{h,cc}`): a register
scoreboard over 512 registers, load and store queues as [T, N] rings of
deallocation times, and the seven detailed stall counters.  The commit
algebra is `ops/iocoom_commit.py`.
"""

from __future__ import annotations

import dataclasses

import torch

from graphite_tpu_torch.engine.state import _TensorTree

NUM_REGISTERS = 512  # `iocoom_core_model.h:77`

# producing units of a register (`iocoom_core_model.h:13-19`)
UNIT_INVALID = 0
UNIT_LOAD = 1
UNIT_EXEC = 3

STALL_NAMES = (
    "load_queue", "store_queue", "l1icache", "intra_ins_l1dcache",
    "inter_ins_l1dcache", "intra_ins_execution_unit",
    "inter_ins_execution_unit",
)


@dataclasses.dataclass(frozen=True)
class IocoomParams:
    """[core/iocoom] knobs (`carbon_sim.cfg:180-185`)."""

    num_load_queue_entries: int = 8
    num_store_queue_entries: int = 8
    speculative_loads_enabled: bool = True
    multiple_outstanding_rfos_enabled: bool = True

    @classmethod
    def from_config(cls, cfg) -> "IocoomParams":
        return cls(
            num_load_queue_entries=cfg.get_int(
                "core/iocoom/num_load_queue_entries", 8),
            num_store_queue_entries=cfg.get_int(
                "core/iocoom/num_store_queue_entries", 8),
            speculative_loads_enabled=cfg.get_bool(
                "core/iocoom/speculative_loads_enabled", True),
            multiple_outstanding_rfos_enabled=cfg.get_bool(
                "core/iocoom/multiple_outstanding_RFOs_enabled", True),
        )


@dataclasses.dataclass
class IocoomState(_TensorTree):
    reg_ready_ps: torch.Tensor   # int64[T, R] register scoreboard
    reg_unit: torch.Tensor       # uint8[T, R] producing unit
    lq_dealloc_ps: torch.Tensor  # int64[T, LQ] load-queue ring
    lq_idx: torch.Tensor         # int32[T] next allocate index
    sq_dealloc_ps: torch.Tensor  # int64[T, SQ]
    sq_addr: torch.Tensor        # int32[T, SQ] line of each store
    sq_idx: torch.Tensor         # int32[T]
    load_queue_stall_ps: torch.Tensor        # int64[T] each
    store_queue_stall_ps: torch.Tensor
    l1icache_stall_ps: torch.Tensor
    intra_ins_l1dcache_stall_ps: torch.Tensor
    inter_ins_l1dcache_stall_ps: torch.Tensor
    intra_ins_execution_unit_stall_ps: torch.Tensor
    inter_ins_execution_unit_stall_ps: torch.Tensor

    def detailed_stalls(self) -> dict:
        """`SimResults.detailed_stalls`: name -> numpy int64[T]."""
        return {n: getattr(self, f"{n}_stall_ps").cpu().numpy()
                for n in STALL_NAMES}


def init_iocoom_state(n_tiles: int, p: IocoomParams, device) -> IocoomState:
    T = n_tiles
    i64 = torch.int64

    def z(shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=device)

    return IocoomState(
        reg_ready_ps=z((T, NUM_REGISTERS)),
        reg_unit=z((T, NUM_REGISTERS), torch.uint8),
        lq_dealloc_ps=z((T, p.num_load_queue_entries)),
        lq_idx=z(T, torch.int32),
        sq_dealloc_ps=z((T, p.num_store_queue_entries)),
        sq_addr=torch.full((T, p.num_store_queue_entries), -1,
                           dtype=torch.int32, device=device),
        sq_idx=z(T, torch.int32),
        **{f"{n}_stall_ps": z(T) for n in STALL_NAMES},
    )
