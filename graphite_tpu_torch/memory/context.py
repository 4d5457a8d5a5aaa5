"""The memory engine's per-run constants and per-iteration record view.

`MemCtx` holds what every phase reads besides the state: the parameters,
the timing constants, and their device copies in the form the kernels
take (per-tile set counts, way counts and cycle counts as int arrays, the
memory-controller tiles).  `MemRec` is the current record's fields for
every lane, the JAX engine's `RecView` (`graphite_tpu/memory/engine.py:
579`): the plain phases read it, the kernels read the same fields from
the fetched lanes and the trace themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphite_tpu_torch.memory.common import (
    MemTiming, dram_round_trip, mem_net_latency_ps,
)
from graphite_tpu_torch.memory.params import MemParams
from graphite_tpu_torch.time_types import cycles_to_ps

# columns of MemCtx.cycle_ps (memory/common.py MemTiming.cycle_table)
(CYC_L1I_DAT, CYC_L1I_TAG, CYC_L1D_DAT, CYC_L1D_TAG, CYC_L2_DAT, CYC_L2_TAG,
 CYC_SYNC_CORE_L1D, CYC_SYNC_CORE_L1I, CYC_SYNC_L1D_L2, CYC_SYNC_L1I_L2,
 CYC_SYNC_L2_NET) = range(11)


def _per_tile(v, n: int, device) -> torch.Tensor:
    a = np.broadcast_to(np.asarray(v, np.int64), (n,))
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(
        device)


class MemCtx:
    def __init__(self, mp: MemParams, device):
        T = mp.n_tiles
        self.mp = mp
        self.device = torch.device(device)
        self.timing = MemTiming.build(mp, device)
        # the kernels' copies
        self.cyc = self.timing.cycle_table(T, device)          # int64[T, 11]
        self.sets = torch.stack([
            _per_tile(lv.sets_mod, T, device)
            for lv in (mp.l1i, mp.l1d, mp.l2)])                  # int32[3, T]
        self.ways = torch.stack([
            _per_tile(lv.num_ways if lv.ways_limit is None else lv.ways_limit,
                      T, device)
            for lv in (mp.l1i, mp.l1d, mp.l2)])                  # int32[3, T]
        # the plain versions' geometry: each level's set count (an int, or
        # int64[T] for per-tile geometries) and way count (None, or
        # int64[T]), on the device once
        for name, lv in (("l1i", mp.l1i), ("l1d", mp.l1d), ("l2", mp.l2)):
            sm, wl = lv.sets_mod, lv.ways_limit
            setattr(self, f"{name}_sets", sm if isinstance(sm, int) else
                    torch.from_numpy(sm.astype(np.int64)).to(device))
            setattr(self, f"{name}_ways", None if wl is None else
                    torch.from_numpy(wl.astype(np.int64)).to(device))
        self.mc = torch.tensor(mp.mc_tiles, dtype=torch.int32,
                               device=device)
        self.mc64 = self.mc.to(torch.int64)
        self.tiles = torch.arange(T, dtype=torch.int64, device=device)
        # the shared-L2 slices' DRAM round trips (int64[T], models on)
        self.dram_rt = (dram_round_trip(mp, device) if mp.is_shl2
                        else None)
        # the card's CUDA graphs of the plain phases (memory/engine.py)
        from graphite_tpu_torch.memory.engine import PhaseGraphs

        if mp.is_shl2:
            from graphite_tpu_torch.memory.engine_shl2 import (
                shl2_graph_phases,
            )

            self.phase_graphs = PhaseGraphs(shl2_graph_phases)
        else:
            self.phase_graphs = PhaseGraphs()
        # the zero-load MEMORY-net latency of every (src, dst) pair, for
        # header-only (False) and line-carrying (True) messages
        on = torch.ones((), dtype=torch.bool, device=device)
        self.lat = {
            rep: mem_net_latency_ps(
                mp, self.tiles[:, None], self.tiles[None, :],
                mp.rep_bits if rep else mp.req_bits, on).expand(T, T)
            .contiguous()
            for rep in (False, True)}

    def net_ps(self, src, dst, enabled, rep=False) -> torch.Tensor:
        """The latency of a message src -> dst (`rep`: a bool, or a bool
        tensor per message, for line-carrying ones), 0 while models are
        off (`mem_net_latency_ps`)."""
        if isinstance(rep, bool):
            lat = self.lat[rep][src, dst]
        else:
            lat = torch.where(rep, self.lat[True][src, dst],
                              self.lat[False][src, dst])
        return torch.where(enabled, lat, 0)

    def cycle_ps(self, fmhz, enabled) -> torch.Tensor:
        """int64[T, 11]: the per-tile cycle counts (`CYC_*` order) at each
        tile's frequency, 0 while models are off (the engine's
        `ccycles`)."""
        return torch.where(enabled,
                           cycles_to_ps(self.cyc, fmhz.to(torch.int64)[:, None]),
                           0)

    def home_of(self, line: torch.Tensor) -> torch.Tensor:
        """The home tile of each (non-negative) line, int64."""
        return self.mc64[torch.fmod(line.to(torch.int64), len(self.mp.mc_tiles))]

    def home_of_floor(self, line: torch.Tensor) -> torch.Tensor:
        """Home of a possibly negative (victim) line: flooring modulo, as
        the JAX package's `%` on a traced array."""
        return self.mc64[torch.remainder(line.to(torch.int64),
                                         len(self.mp.mc_tiles))]


@dataclasses.dataclass
class MemRec:
    """The current record of every lane (addresses zero-extended)."""

    op: torch.Tensor      # int32[T]
    flags: torch.Tensor   # int32[T]
    pc: torch.Tensor      # int64[T]
    addr0: torch.Tensor   # int64[T]
    addr1: torch.Tensor   # int64[T]
    aux0: torch.Tensor    # int32[T]
    aux1: torch.Tensor    # int32[T]

    @classmethod
    def fetch(cls, lanes, trace, idx: torch.Tensor) -> "MemRec":
        L = trace.addr0.shape[1]
        col = torch.clamp(idx, max=L - 1).to(torch.int64)[:, None]
        return cls(op=lanes.op, flags=lanes.flags, pc=lanes.pc,
                   addr0=torch.gather(trace.addr0, 1, col)[:, 0],
                   addr1=torch.gather(trace.addr1, 1, col)[:, 0],
                   aux0=lanes.aux0, aux1=lanes.aux1)
