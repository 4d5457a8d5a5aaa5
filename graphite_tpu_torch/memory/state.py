"""Memory-subsystem state as tensors: caches, directory, mailboxes, DRAM.

Port of `graphite_tpu/memory/state.py` for the private-L1/L2 directory
protocols (`MemState`), and of the shared-L2 engine's state
(`graphite_tpu/memory/engine_shl2.py:95-348`: `ShL2State`, its embedded
directory `ShL2Dir` and its transactions `ShL2Txn`).  Every leaf keeps the JAX leaf's shape and, where
torch has the type, its dtype.  The uint32 words do not: torch has no
uint32 `>>` or `+` worth trusting, so

 - the directory sharer bitvectors and the transactions' pending sets
   (`DirectoryArrays.sharers`, `TxnState.pending`, and the shared-L2
   engine's `ShL2Dir.sharers`, `ShL2Txn.pending`) hold each uint32 word's
   bit pattern as int32 — they are only ever and-ed, or-ed, tested bit by
   bit and compared with 0, for which the sign does not matter, and at
   1024 tiles the sharers store is 2.1 GB as int32 (4.3 GB as int64);
 - the miss-type bitmaps, the line-utilization counters and the
   functional word store (`mt`, `l2_util`, `func_mem`) hold each word
   zero-extended to int64, masked to 32 bits wherever it is written.

The JAX package's directory staging rows (`skey`/`sval`/`sn`) and the
per-phase skip counters have no counterpart: the port writes the
directory in place (the staging is bit-exact by construction, so leaving
it out changes no result).  `noc` is the MEMORY net's contention state
(`NocState` or `AtacState`, as in the JAX package).  Mailbox layout and
ownership are as in the JAX package (see its module docstring).
"""

from __future__ import annotations

import dataclasses

import torch

from graphite_tpu_torch.engine.state import _TensorTree
from graphite_tpu_torch.memory.params import MemParams

# message types (subset of `shmem_msg.h:12-30`)
MSG_NONE = 0
MSG_SH_REQ = 1
MSG_EX_REQ = 2
MSG_INV_REQ = 3
MSG_FLUSH_REQ = 4
MSG_WB_REQ = 5
MSG_INV_REP = 6
MSG_FLUSH_REP = 7
MSG_WB_REP = 8
MSG_SH_REP = 9
MSG_EX_REP = 10
MSG_NULLIFY = 11
MSG_EXCL_REP = 12    # shared-L2 MESI: the EXCLUSIVE grant of a lone read

# directory states (`directory_state.h`)
DIR_UNCACHED = 0
DIR_SHARED = 1
DIR_MODIFIED = 2
DIR_OWNED = 3
DIR_EXCLUSIVE = 4    # shared-L2 MESI: one clean exclusive L1 copy

# requester phases
PHASE_IDLE = 0
PHASE_WAIT_REPLY = 1

# memory components (indices into MemParams.module_domains)
MOD_CORE = 0
MOD_L1I = 1
MOD_L1D = 2
MOD_L2 = 3
MOD_DIR = 4
MOD_NET_MEM = 5

# packed directory-entry word (int64[T, DS, DW]); the all-zero word is
# the free entry (tag+1 = 0, owner+1 = 0, UNCACHED, 0 sharers)
DIR_TAG_BITS = 34        # bits 0..33: line + 1 (0 = free)
DIR_STATE_SHIFT = 34     # bits 34..36: directory state
DIR_OWNER_SHIFT = 37     # bits 37..49: owner tile + 1
DIR_NSH_SHIFT = 50       # bits 50..62: sharer count
DIR_ID_BITS = 13         # owner/nsharers field width (tiles <= 8190)

# the shared-L2 engine's embedded directory word (int64[T, S2, W2], one a
# slice line; all-zero = UNCACHED, owner -1, no sharers, cloc 0)
SHL2_STATE_SHIFT = 0     # bits 0..2: directory state
SHL2_OWNER_SHIFT = 3     # bits 3..15: owner tile + 1
SHL2_NSH_SHIFT = 16      # bits 16..28: sharer count
SHL2_CLOC_SHIFT = 29     # bits 29..30: caching component (MOD_L1I/L1D)
# the L2 slice's data state of a line whose DRAM fetch is in flight
DATA_INVALID = 5
# `ShL2Txn.dram_ready_ps` of a home with no fetch in flight
FAR = 2**62
# the shared-L2 engine's phases, in the order of `ShL2State.phase_skips`
SHL2_PHASE_NAMES = ("requester", "sharer", "home_evict", "home_finish",
                    "home_start", "requester_fill")

# miss-type tracking hash space: 2^16 buckets = 2048 words per set
MT_BITS = 1 << 16
MT_WORDS = MT_BITS // 32
MT_FETCHED, MT_EVICTED, MT_INVALIDATED = 0, 1, 2


@dataclasses.dataclass
class CacheArrays(_TensorTree):
    """One cache level over all tiles: meta int64[T, S, W] = line << 16 |
    state << 8 | lru (`graphite_tpu/memory/cache_array.py`)."""

    meta: torch.Tensor


@dataclasses.dataclass
class DirectoryArrays(_TensorTree):
    entry: torch.Tensor      # int64[T, DS, DW] packed words (layout above)
    sharers: torch.Tensor    # int32[T, DS, DW*SW] uint32 bit patterns


@dataclasses.dataclass
class TxnState(_TensorTree):
    """One active directory transaction per home tile."""

    active: torch.Tensor        # bool[T]
    mtype: torch.Tensor         # uint8[T]
    line: torch.Tensor          # int32[T]
    requester: torch.Tensor     # int32[T]
    time_ps: torch.Tensor       # int64[T]
    pending: torch.Tensor       # int32[T, SW] uint32 bit patterns
    data_cached: torch.Tensor   # bool[T]
    saved_valid: torch.Tensor   # bool[T]
    saved_type: torch.Tensor    # uint8[T]
    saved_line: torch.Tensor    # int32[T]
    saved_requester: torch.Tensor  # int32[T]
    saved_time_ps: torch.Tensor    # int64[T]
    last_line: torch.Tensor     # int32[T]
    last_done_ps: torch.Tensor  # int64[T]
    cdata_line: torch.Tensor    # int32[T]
    cdata_valid: torch.Tensor   # bool[T]


@dataclasses.dataclass
class MemMailboxes(_TensorTree):
    req_type: torch.Tensor    # uint8[T(requester)]
    req_home: torch.Tensor    # int32[T]
    req_line: torch.Tensor    # int32[T]
    req_time: torch.Tensor    # int64[T]
    evict_type: torch.Tensor  # uint8[T(home), T(src)]
    evict_line: torch.Tensor  # int32[T, T]
    evict_time: torch.Tensor  # int64[T, T]
    fwd_type: torch.Tensor    # uint8[T(sharer), T(home)]
    fwd_line: torch.Tensor    # int32[T, T]
    fwd_time: torch.Tensor    # int64[T, T]
    ack_type: torch.Tensor    # uint8[T(home), T(sharer)]
    ack_line: torch.Tensor    # int32[T, T]
    ack_time: torch.Tensor    # int64[T, T]
    rep_type: torch.Tensor    # uint8[T(requester)]
    rep_time: torch.Tensor    # int64[T]


@dataclasses.dataclass
class RequesterState(_TensorTree):
    phase: torch.Tensor       # int32[T]
    slot: torch.Tensor        # int32[T]
    acc_ps: torch.Tensor      # int64[T]
    clock_ps: torch.Tensor    # int64[T]
    line: torch.Tensor        # int32[T]
    is_write: torch.Tensor    # bool[T]
    component: torch.Tensor   # uint8[T]
    instr_buf: torch.Tensor   # int32[T]
    slot_lat_ps: torch.Tensor  # int64[T, 3]


COUNTER_NAMES = (
    "l1i_hits", "l1i_misses", "l1d_read_hits", "l1d_read_misses",
    "l1d_write_hits", "l1d_write_misses", "l2_hits", "l2_misses",
    "evictions", "invalidations", "dir_accesses", "dir_broadcasts",
    "dram_reads", "dram_writes", "dram_total_lat_ps", "l2_cold_misses",
    "l2_capacity_misses", "l2_sharing_misses", "line_util_hist",
    "line_util_reads", "line_util_writes",
)


@dataclasses.dataclass
class MemCounters(_TensorTree):
    l1i_hits: torch.Tensor        # int64[T] each, line_util_hist [T, 8]
    l1i_misses: torch.Tensor
    l1d_read_hits: torch.Tensor
    l1d_read_misses: torch.Tensor
    l1d_write_hits: torch.Tensor
    l1d_write_misses: torch.Tensor
    l2_hits: torch.Tensor
    l2_misses: torch.Tensor
    evictions: torch.Tensor
    invalidations: torch.Tensor
    dir_accesses: torch.Tensor
    dir_broadcasts: torch.Tensor
    dram_reads: torch.Tensor
    dram_writes: torch.Tensor
    dram_total_lat_ps: torch.Tensor
    l2_cold_misses: torch.Tensor
    l2_capacity_misses: torch.Tensor
    l2_sharing_misses: torch.Tensor
    line_util_hist: torch.Tensor
    line_util_reads: torch.Tensor
    line_util_writes: torch.Tensor


@dataclasses.dataclass
class MemState(_TensorTree):
    l1i: CacheArrays
    l1d: CacheArrays
    l2: CacheArrays
    l2_cloc: torch.Tensor        # uint8[T, S2, W2] which L1 holds the line
    l2_util: "torch.Tensor | None"  # int64[T, S2, W2] (tracking on)
    directory: DirectoryArrays
    txn: TxnState
    mail: MemMailboxes
    req: RequesterState
    counters: MemCounters
    func_mem: torch.Tensor       # int64[mem_words + 1] uint32 words
    func_errors: torch.Tensor    # int64[]
    mt: "torch.Tensor | None" = None  # int64[T, 3, MT_WORDS] (tracking on)
    # the MEMORY net's contention state: a NocState (per-port queues)
    # under emesh_hop_by_hop, an AtacState (hub queues) under atac
    noc: "object | None" = None


@dataclasses.dataclass
class ShL2Dir(_TensorTree):
    """The directory embedded in each home's L2 slice, one entry a slice
    line (`graphite_tpu/memory/engine_shl2.py` ShL2Dir)."""

    word: torch.Tensor       # int64[T(home), S2, W2] packed (SHL2_* above)
    sharers: torch.Tensor    # int32[T, S2, W2*SW] uint32 bit patterns


@dataclasses.dataclass
class ShL2Txn(_TensorTree):
    """One active transaction per home slice."""

    active: torch.Tensor          # bool[T]
    mtype: torch.Tensor           # uint8[T]
    line: torch.Tensor            # int32[T]
    requester: torch.Tensor       # int32[T]
    req_comp: torch.Tensor        # uint8[T] MOD_L1I / MOD_L1D
    time_ps: torch.Tensor         # int64[T]
    pending: torch.Tensor         # int32[T, SW] uint32 bit patterns
    dram_ready_ps: torch.Tensor   # int64[T] (FAR: no fetch in flight)
    got_flush: torch.Tensor       # bool[T]: dirty data arrived
    saved_valid: torch.Tensor     # bool[T]
    saved_type: torch.Tensor      # uint8[T]
    saved_line: torch.Tensor      # int32[T]
    saved_requester: torch.Tensor  # int32[T]
    saved_comp: torch.Tensor      # uint8[T]
    saved_time_ps: torch.Tensor   # int64[T]
    last_line: torch.Tensor       # int32[T]
    last_done_ps: torch.Tensor    # int64[T]


@dataclasses.dataclass
class ShL2State(_TensorTree):
    """The shared-L2 engine's state (`engine_shl2.py` ShL2State): private
    L1s, each home's L2 slice with its embedded directory, and the
    mailboxes, requesters and counters the private-L2 engine has too.
    `phase_skips` counts, in `SHL2_PHASE_NAMES` order, the phases the CPU
    path skipped (on the card every phase runs and nothing is counted);
    the JAX-only `live` is recomputed where a checkpoint needs it."""

    l1i: CacheArrays
    l1d: CacheArrays
    l2: CacheArrays              # the home's slice (home-indexed lines)
    dir: ShL2Dir
    mail: MemMailboxes
    txn: ShL2Txn
    req: RequesterState
    counters: MemCounters
    func_mem: torch.Tensor       # int64[mem_words + 1] uint32 words
    func_errors: torch.Tensor    # int64[]
    phase_skips: torch.Tensor    # int64[6]
    noc: "object | None" = None  # the MEMORY net's contention state


def make_cache(n_tiles: int, num_sets: int, num_ways: int,
               device) -> CacheArrays:
    """Free lines (-1) with LRU ranks 0..W-1 in every set."""
    lru0 = torch.arange(num_ways, dtype=torch.int64, device=device)
    meta = ((-1) << 16) | lru0
    return CacheArrays(meta=meta.expand(n_tiles, num_sets, num_ways)
                       .contiguous())


def _z(device):
    def z(shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full((shape,) if isinstance(shape, int) else shape,
                          value, dtype=dtype, device=device)

    return z, full


def init_mem_common(mp: MemParams, device) -> dict:
    """The pieces both engines share (`graphite_tpu/memory/state.py`
    init_mem_common): L1s and L2, mailboxes, requesters, counters, the
    functional store and the MEMORY net's queues."""
    T = mp.n_tiles
    i32, u8 = torch.int32, torch.uint8
    z, full = _z(device)
    mail = MemMailboxes(
        req_type=z(T, u8), req_home=z(T, i32), req_line=z(T, i32),
        req_time=z(T),
        evict_type=z((T, T), u8), evict_line=z((T, T), i32),
        evict_time=z((T, T)),
        fwd_type=z((T, T), u8), fwd_line=z((T, T), i32),
        fwd_time=z((T, T)),
        ack_type=z((T, T), u8), ack_line=z((T, T), i32),
        ack_time=z((T, T)),
        rep_type=z(T, u8), rep_time=z(T),
    )
    req = RequesterState(
        phase=z(T, i32), slot=z(T, i32), acc_ps=z(T), clock_ps=z(T),
        line=z(T, i32), is_write=z(T, torch.bool), component=z(T, u8),
        instr_buf=full(T, -1, i32), slot_lat_ps=z((T, 3)),
    )
    counters = MemCounters(**{
        n: z((T, 8) if n == "line_util_hist" else T) for n in COUNTER_NAMES})
    return dict(
        l1i=make_cache(T, mp.l1i.num_sets, mp.l1i.num_ways, device),
        l1d=make_cache(T, mp.l1d.num_sets, mp.l1d.num_ways, device),
        l2=make_cache(T, mp.l2.num_sets, mp.l2.num_ways, device),
        mail=mail, req=req, counters=counters,
        # +1 scratch word absorbing masked-off dummy writes
        func_mem=z(max(mp.func_mem_words, 1) + 1),
        func_errors=z(()),
        noc=_init_noc(mp, device))


def init_mem_state(mp: MemParams, device) -> MemState:
    """The zero state (`graphite_tpu/memory/state.py` init_mem_state)."""
    T = mp.n_tiles
    SW = mp.sharer_words
    DS, DW = mp.dir_sets, mp.dir_ways
    i32, u8 = torch.int32, torch.uint8
    z, full = _z(device)
    txn = TxnState(
        active=z(T, torch.bool), mtype=z(T, u8), line=z(T, i32),
        requester=z(T, i32), time_ps=z(T), pending=z((T, SW), i32),
        data_cached=z(T, torch.bool), saved_valid=z(T, torch.bool),
        saved_type=z(T, u8), saved_line=z(T, i32),
        saved_requester=z(T, i32), saved_time_ps=z(T),
        last_line=full(T, -1, i32), last_done_ps=z(T),
        cdata_line=full(T, -1, i32), cdata_valid=z(T, torch.bool),
    )
    l2_shape = (T, mp.l2.num_sets, mp.l2.num_ways)
    return MemState(
        l2_cloc=z(l2_shape, u8),
        l2_util=(z(l2_shape) if mp.l2.track_line_utilization else None),
        directory=DirectoryArrays(entry=z((T, DS, DW)),
                                  sharers=z((T, DS, DW * SW), i32)),
        txn=txn,
        mt=(z((T, 3, MT_WORDS)) if mp.l2.track_miss_types else None),
        **init_mem_common(mp, device),
    )


def init_shl2_state(mp: MemParams, device) -> ShL2State:
    """The shared-L2 engine's zero state (`graphite_tpu/memory/
    engine_shl2.py` init_shl2_state)."""
    T = mp.n_tiles
    SW = mp.sharer_words
    S2, W2 = mp.l2.num_sets, mp.l2.num_ways
    i32, u8, b = torch.int32, torch.uint8, torch.bool
    z, full = _z(device)
    txn = ShL2Txn(
        active=z(T, b), mtype=z(T, u8), line=z(T, i32),
        requester=z(T, i32), req_comp=z(T, u8), time_ps=z(T),
        pending=z((T, SW), i32), dram_ready_ps=full(T, FAR, torch.int64),
        got_flush=z(T, b), saved_valid=z(T, b), saved_type=z(T, u8),
        saved_line=z(T, i32), saved_requester=z(T, i32),
        saved_comp=z(T, u8), saved_time_ps=z(T),
        last_line=full(T, -1, i32), last_done_ps=z(T),
    )
    return ShL2State(
        dir=ShL2Dir(word=z((T, S2, W2)), sharers=z((T, S2, W2 * SW), i32)),
        txn=txn, phase_skips=z(len(SHL2_PHASE_NAMES)),
        **init_mem_common(mp, device))


def _init_noc(mp: MemParams, device):
    """The MEMORY net's own queue state (`graphite_tpu/engine/
    simulator.py:710-730`), or None for a zero-load net."""
    if mp.net_hbh is not None:
        from graphite_tpu_torch.models.network_hop_by_hop import (
            init_noc_state,
        )

        return init_noc_state(mp.net_hbh, device)
    if mp.net_atac is not None:
        from graphite_tpu_torch.models.network_atac import init_atac_state

        return init_atac_state(mp.net_atac, device)
    return None
