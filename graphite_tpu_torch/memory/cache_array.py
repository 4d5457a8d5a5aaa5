"""Set-associative cache arrays, row form (plain PyTorch).

Port of `graphite_tpu/memory/cache_array.py`.  A cache level across all
tiles is one tensor `meta int64[T, S, W] = line << 16 | state << 8 | lru`
(line -1 = free).  Each engine phase gathers every lane's set row once
(`gather_row`), makes every lookup / victim / insert decision on the
[T, W] row, and writes the row back once (`scatter_row`).  Rows belong
to their lane, so the write-back never collides.

Set index = line mod the (per-tile, for heterogeneous geometries) set
count.  Replacement: LRU with invalid-way-first victims, or round_robin
(the rank permutation doubles as the rotation state).  The CUDA kernels
of the requester phases carry the same functions as device code
(`csrc/mem_common.cuh`).
"""

from __future__ import annotations

import dataclasses

import torch

from graphite_tpu_torch.intmath import nn_mod

# CacheState (`cache_state.h`)
INVALID = 0
SHARED = 1
MODIFIED = 2
EXCLUSIVE = 3
OWNED = 4

_READABLE = (1 << SHARED) | (1 << MODIFIED) | (1 << EXCLUSIVE) | (1 << OWNED)
_WRITABLE = (1 << MODIFIED) | (1 << EXCLUSIVE)


def state_readable(state: torch.Tensor) -> torch.Tensor:
    return ((_READABLE >> state) & 1).to(torch.bool)


def state_writable(state: torch.Tensor) -> torch.Tensor:
    return ((_WRITABLE >> state) & 1).to(torch.bool)


def pack(line, state, lru) -> torch.Tensor:
    return (line << 16) | (state << 8) | lru


def unpack(meta: torch.Tensor):
    """(line, state, lru), int64.  torch's `>>` on int64 is arithmetic,
    so a free line (-1) unpacks to -1."""
    return meta >> 16, (meta >> 8) & 0xFF, meta & 0xFF


@dataclasses.dataclass
class CacheRow:
    tag: torch.Tensor   # int64[T, W]
    st: torch.Tensor    # int64[T, W]
    lru: torch.Tensor   # int64[T, W]
    sets: torch.Tensor  # int64[T]
    rows: torch.Tensor  # int64[T]: 0..T-1
    ways: torch.Tensor  # int64[W]: 0..W-1


def set_index(line: torch.Tensor, sets_mod, nonneg: bool) -> torch.Tensor:
    """`line mod sets` (`sets_mod` an int, or int64[T] per tile) —
    truncating for the non-negative record- and
    mailbox-derived lines (`nonneg`), flooring otherwise (a victim line
    read off a free way is -1), as the JAX package does."""
    line = line.to(torch.int64)
    return (nn_mod(line, sets_mod) if nonneg
            else torch.remainder(line, sets_mod))


def gather_row(meta: torch.Tensor, line: torch.Tensor, sets_mod,
               nonneg: bool = True) -> CacheRow:
    T, _, W = meta.shape
    sets = set_index(line, sets_mod, nonneg)
    rows = torch.arange(T, device=meta.device)
    tag, st, lru = unpack(meta[rows, sets])
    return CacheRow(tag=tag, st=st, lru=lru, sets=sets, rows=rows,
                    ways=torch.arange(W, device=meta.device))


def scatter_row(meta: torch.Tensor, row: CacheRow) -> None:
    """Write each lane's row back in place (rows are unique per lane; an
    untouched lane's row packs back to its stored value)."""
    meta[row.rows, row.sets] = pack(row.tag, row.st, row.lru)


def _take(x: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, way[:, None])[:, 0]


def _onehot(row: CacheRow, way: torch.Tensor) -> torch.Tensor:
    return row.ways[None, :] == way[:, None]


def first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 when none), int64."""
    return torch.argmax(m.to(torch.int8), dim=1)


def _col(v):
    """A per-lane value as a [T, 1] column (a Python int stays as is)."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def row_lookup(row: CacheRow, line: torch.Tensor):
    """(hit bool[T], way int64[T], state int64[T])."""
    way_hits = (row.tag == line[:, None]) & (row.st != INVALID)
    hit = way_hits.any(dim=1)
    way = first_true(way_hits)
    st = torch.where(hit, _take(row.st, way), INVALID)
    return hit, way, st


def row_touch(row: CacheRow, way, mask) -> CacheRow:
    rank = _take(row.lru, way)[:, None]
    new_lru = torch.where(_onehot(row, way), 0, row.lru + (row.lru < rank))
    return dataclasses.replace(
        row, lru=torch.where(mask[:, None], new_lru, row.lru))


def row_set_state(row: CacheRow, way, new_state, mask) -> CacheRow:
    sel = _onehot(row, way) & mask[:, None]
    return dataclasses.replace(
        row, st=torch.where(sel, _col(new_state), row.st))


def row_invalidate(row: CacheRow, line, mask) -> CacheRow:
    hit, way, _ = row_lookup(row, line)
    return row_set_state(row, way, INVALID, mask & hit)


def row_pick_victim(row: CacheRow, policy: str = "lru", ways=None):
    """(way, victim_valid, victim_line, victim_state), int64 but the
    mask: lru — first invalid usable way, else the max-rank way;
    round_robin — the max-rank way whatever its state.  `ways` (int64[T])
    masks the padded ways of smaller per-tile geometries."""
    usable = None
    if ways is not None:
        usable = row.ways[None, :] < ways[:, None]
    lru_eff = row.lru if usable is None else torch.where(usable, row.lru, -1)
    lru_way = torch.argmax(lru_eff, dim=1)
    if policy == "round_robin":
        way = lru_way
        victim_state = _take(row.st, way)
        victim_valid = victim_state != INVALID
    else:
        inv = row.st == INVALID
        if usable is not None:
            inv = inv & usable
        any_inv = inv.any(dim=1)
        way = torch.where(any_inv, first_true(inv), lru_way)
        victim_state = _take(row.st, way)
        victim_valid = ~any_inv
    return way, victim_valid, _take(row.tag, way), victim_state


def row_insert(row: CacheRow, line, way, new_state, mask) -> CacheRow:
    sel = _onehot(row, way) & mask[:, None]
    out = dataclasses.replace(
        row, tag=torch.where(sel, line[:, None], row.tag),
        st=torch.where(sel, _col(new_state), row.st))
    return row_touch(out, way, mask)


def lookup(meta: torch.Tensor, line: torch.Tensor, sets_mod):
    """Element lookup of (possibly -1) lines: (hit, way, state)."""
    return row_lookup(gather_row(meta, line, sets_mod, nonneg=False), line)
