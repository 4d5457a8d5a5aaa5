"""Helpers shared by the memory engine's phases (plain PyTorch).

Port of the helpers of `graphite_tpu/memory/engine.py`: sharer-bitvector
ops (`:92-127`, `:170`), the packed directory-entry fields (`:150-168`),
the earliest-message elections (`:178-224`), the zero-load MEMORY-network
latency (`:227-249`), the line-utilization
and miss-type words (`:386-474`), the slot decomposition of a record
(`:602-628`) and the per-call timing constants of `memory_engine_step`
(`:1323-1360`).

Sharer words are int32 bit patterns of uint32 words (memory/state.py), so
every bit op here masks where a sign could leak: `1 << 31` is the int32
minimum, `(w >> b) & 1` reads bit b whatever the sign, and popcount
works on the word zero-extended to int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphite_tpu_torch.intmath import nn_div, nn_mod
from graphite_tpu_torch.memory.params import MemParams
from graphite_tpu_torch.memory.state import (
    DIR_ID_BITS, DIR_NSH_SHIFT, DIR_OWNER_SHIFT, DIR_STATE_SHIFT,
    DIR_TAG_BITS, MOD_CORE, MOD_DIR, MOD_L1D, MOD_L1I, MOD_L2, MOD_NET_MEM,
    MSG_NONE, MT_BITS, SHL2_CLOC_SHIFT, SHL2_NSH_SHIFT, SHL2_OWNER_SHIFT,
    SHL2_STATE_SHIFT,
)
from graphite_tpu_torch.time_types import cycles_to_ps
from graphite_tpu_torch.trace.schema import (
    FLAG_MEM0_VALID, FLAG_MEM1_VALID, Op,
)

FAR = 2**62
U32 = 0xFFFFFFFF
_TAG_MASK = (1 << DIR_TAG_BITS) - 1
_ID_MASK = (1 << DIR_ID_BITS) - 1


def arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


# --- sharer bitvectors: [T, SW] int32 words --------------------------------

def _bit(idx: torch.Tensor):
    idx = idx.to(torch.int64)
    return nn_div(idx, 32), nn_mod(idx, 32)


def _word_bit(b: torch.Tensor) -> torch.Tensor:
    """int32 word with bit b set (bit 31 is the sign bit)."""
    return (torch.ones_like(b) << b).to(torch.int32)


def set_bit(words, idx, mask):
    T = words.shape[0]
    rows = arange(T, words.device)
    w, b = _bit(idx)
    cur = words[rows, w]
    out = words.clone()
    out[rows, w] = torch.where(mask, cur | _word_bit(b), cur)
    return out


def clear_bit(words, idx, mask):
    T = words.shape[0]
    rows = arange(T, words.device)
    w, b = _bit(idx)
    cur = words[rows, w]
    out = words.clone()
    out[rows, w] = torch.where(mask, cur & ~_word_bit(b), cur)
    return out


def test_bit(words, idx):
    rows = arange(words.shape[0], words.device)
    w, b = _bit(idx)
    return ((words[rows, w].to(torch.int64) >> b) & 1) != 0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each uint32 word (SWAR; torch has no popcount)."""
    v = x.to(torch.int64) & U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & U32) >> 24


def popcount(words) -> torch.Tensor:
    """[T, SW] -> int32[T]."""
    return popcount32(words).sum(dim=1).to(torch.int32)


def lowest_sharer(words) -> torch.Tensor:
    """The lowest set bit of each row, int64[T] (-1 when the row is
    empty): the deterministic `DirectoryEntry::getOneSharer`
    (`engine.py:129-141`)."""
    nonzero = words != 0
    w_idx = torch.argmax(nonzero.to(torch.int8), dim=1)
    w = torch.gather(words, 1, w_idx[:, None])[:, 0].to(torch.int64) & U32
    bit = popcount32((w & -w) - 1)
    return torch.where(nonzero.any(dim=1), w_idx * 32 + bit, -1)


def unpack_sharers(words, n: int) -> torch.Tensor:
    """[T, SW] -> bool[T, n] (bit s of row t)."""
    s = torch.arange(n, device=words.device)
    return ((words[:, s // 32].to(torch.int64) >> (s % 32)[None, :]) & 1) != 0


def pack_bits(m: torch.Tensor, sw: int) -> torch.Tensor:
    """bool[T, n] -> [T, SW] int32 words (bit s of row t)."""
    T, n = m.shape
    pad = torch.zeros((T, sw * 32 - n), dtype=torch.bool, device=m.device)
    mm = torch.cat([m, pad], dim=1).reshape(T, sw, 32).to(torch.int64)
    w = (mm << torch.arange(32, device=m.device)).sum(dim=2)
    return (w - ((w >> 31) << 32)).to(torch.int32)   # wrap to int32


# --- packed directory-entry words ------------------------------------------

def dir_tag(word):
    return (word & _TAG_MASK).to(torch.int32) - 1


def dir_state(word):
    return ((word >> DIR_STATE_SHIFT) & 7).to(torch.int32)


def dir_owner(word):
    return ((word >> DIR_OWNER_SHIFT) & _ID_MASK).to(torch.int32) - 1


def dir_nsh(word):
    return ((word >> DIR_NSH_SHIFT) & _ID_MASK).to(torch.int32)


def dir_set_field(word, val, shift: int, mask: int):
    return (word & ~(mask << shift)) | ((val.to(torch.int64) & mask) << shift)


def dir_word(tag, dstate, owner, nsh, base):
    """`base` with (tag, dstate, owner, nsharers) written (None = keep)."""
    w = base
    if tag is not None:
        w = dir_set_field(w, tag.to(torch.int64) + 1, 0, _TAG_MASK)
    if dstate is not None:
        w = dir_set_field(w, dstate, DIR_STATE_SHIFT, 7)
    if owner is not None:
        w = dir_set_field(w, owner.to(torch.int64) + 1, DIR_OWNER_SHIFT,
                          _ID_MASK)
    if nsh is not None:
        w = dir_set_field(w, nsh, DIR_NSH_SHIFT, _ID_MASK)
    return w


# --- the shared-L2 engine's embedded directory rows ------------------------
# (`graphite_tpu/memory/engine_shl2.py:118-182`): each home lane's [T, W2]
# word row and [T, W2, SW] sharer row at one slice set, changed in place
# on the row copies and written back once (`shl2_rows`, `shl2_store`)

def shl2_rows(d, sets, rows):
    """Each home's embedded-directory rows at `sets` (copies)."""
    T, S2, W2 = d.word.shape
    return d.word[rows, sets], d.sharers.view(T, S2, W2, -1)[rows, sets]


def shl2_store(d, sets, rows, dw, dsh) -> None:
    """Write each home's rows back (rows are unique per home)."""
    T, S2, W2 = d.word.shape
    d.word[rows, sets] = dw
    d.sharers.view(T, S2, W2, -1)[rows, sets] = dsh


def shl2_fields(word):
    """(dstate, owner, nsharers) of packed embedded-directory words."""
    return (word & 7, ((word >> SHL2_OWNER_SHIFT) & _ID_MASK) - 1,
            (word >> SHL2_NSH_SHIFT) & _ID_MASK)


def shl2_entry(dw, dsh, way):
    """(word, sharers [T, SW]) at each home's `way`."""
    rows = arange(dw.shape[0], dw.device)
    return dw[rows, way], dsh[rows, way]


def shl2_update(dw, dsh, way, mask, *, dstate=None, owner=None,
                nsharers=None, cloc=None, sharers=None) -> None:
    """Masked in-place write of the fields given at each home's `way` of
    its row copies (`_row_update`, `_rowsh_update`)."""
    rows = arange(dw.shape[0], dw.device)
    cur = dw[rows, way]
    new = cur
    for val, shift, m, add in ((dstate, SHL2_STATE_SHIFT, 7, 0),
                               (owner, SHL2_OWNER_SHIFT, _ID_MASK, 1),
                               (nsharers, SHL2_NSH_SHIFT, _ID_MASK, 0),
                               (cloc, SHL2_CLOC_SHIFT, 3, 0)):
        if val is not None:
            # a Python int fills (no host-to-device copy inside a graph)
            v = (cur.new_full(cur.shape, val) if isinstance(val, int)
                 else val.to(torch.int64).expand(cur.shape))
            new = dir_set_field(new, v + add, shift, m)
    dw[rows, way] = torch.where(mask, new, cur)
    if sharers is not None:
        cur_sh = dsh[rows, way]
        dsh[rows, way] = torch.where(mask[:, None], sharers, cur_sh)


# --- elections -------------------------------------------------------------

def row_earliest(cell_type, cell_time):
    """Earliest nonzero cell per row on the (time, column) total order:
    (col int64[T], found bool[T])."""
    C = cell_type.shape[1]
    key = torch.where(cell_type != MSG_NONE,
                      cell_time * C + arange(C, cell_type.device)[None, :],
                      FAR)
    col = torch.argmin(key, dim=1)
    found = torch.gather(key, 1, col[:, None])[:, 0] < FAR
    return col, found


def req_earliest(mail):
    """Earliest pending request per HOME over the requester lanes, key
    time * T + requester: (requester int64[T], found bool[T])."""
    T = mail.req_type.shape[0]
    dev = mail.req_type.device
    live = mail.req_type != MSG_NONE
    key = torch.where(live, mail.req_time * T + arange(T, dev), FAR)
    bucket = torch.where(live, mail.req_home.to(torch.int64), T)
    best = torch.full((T + 1,), FAR, dtype=torch.int64, device=dev)
    best = best.scatter_reduce(0, bucket, key, "amin", include_self=True)[:T]
    found = best < FAR
    return torch.where(found, nn_mod(best, T), 0), found


# --- the MEMORY network (zero-load) ----------------------------------------

def mem_net_latency_ps(mp: MemParams, src, dst, bits, enabled):
    """`network_model_emesh_hop_counter.cc` zero-load latency plus receive
    serialization, one cycle (magic), or the ATAC zero-load path costs
    under `memory = atac`; 0 while models are disabled."""
    if mp.net_kind == "magic":
        cycles = torch.where(enabled, torch.ones_like(src, dtype=torch.int64),
                             0)
        return cycles_to_ps(cycles, mp.net_freq_mhz)
    if mp.net_atac is not None:
        from graphite_tpu_torch.models.network_atac import atac_zeroload_ps

        return atac_zeroload_ps(mp.net_atac, src, dst, bits, enabled)
    w = mp.mesh_width
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    hops = (torch.abs(nn_mod(src, w) - nn_mod(dst, w))
            + torch.abs(nn_div(src, w) - nn_div(dst, w)))
    flits = (bits + mp.flit_width_bits - 1) // mp.flit_width_bits
    cycles = hops * mp.hop_latency_cycles + torch.where(src == dst, 0, flits)
    cycles = torch.where(enabled, cycles, 0)
    return cycles_to_ps(cycles, mp.net_freq_mhz)


def dram_round_trip(mp: MemParams, device) -> torch.Tensor:
    """int64[T]: each shared-L2 home slice's DRAM fetch round trip with
    the models on (`graphite_tpu/memory/engine_shl2.py:357-365`
    `_dram_lat_ps`): the zero-load MEMORY net to the line's memory
    controller and back, plus the access."""
    home = arange(mp.n_tiles, device)
    mc = torch.tensor(mp.mc_tiles, dtype=torch.int64, device=device)
    on = torch.ones((), dtype=torch.bool, device=device)
    lat = mem_net_latency_ps(mp, home, mc[home % len(mp.mc_tiles)],
                             mp.rep_bits, on)
    return 2 * lat + (mp.dram_latency_ns + mp.dram_processing_ns) * 1000


# --- L2 line utilization: per line, reads (low 16) | writes << 16 -----------

def util_inc(cur, is_write, mask):
    inc = torch.where(is_write, 1 << 16, 1)
    fld = torch.where(is_write, cur >> 16, cur & 0xFFFF)
    return torch.where(mask & (fld < 0xFFFF), cur + inc, cur)


def util_classify(counters, util_val, mask, enabled) -> None:
    """Histogram a departing line's counters (log2 buckets, 7 = >= 64),
    in place on `counters`."""
    rd = util_val & 0xFFFF
    wr = util_val >> 16
    total = rd + wr
    # 32 - clz(total) of the int32 total: its bit length
    bucket = torch.clamp(bit_length(total), max=7)
    m = mask & enabled
    rows = arange(util_val.shape[0], util_val.device)
    counters.line_util_hist[rows, bucket] += m.to(torch.int64)
    counters.line_util_reads.add_(torch.where(m, rd, 0))
    counters.line_util_writes.add_(torch.where(m, wr, 0))


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """32 - clz of a uint32 value (0 for 0); torch has no clz."""
    v = x.to(torch.int64) & U32
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (v >> s) != 0
        n = n + torch.where(big, s, 0)
        v = torch.where(big, v >> s, v)
    return n + (v != 0).to(torch.int64)


def mt_bit(line):
    h = line.to(torch.int64) & U32 & (MT_BITS - 1)
    return h // 32, h % 32


def mt_test(mt, row: int, line):
    rows = arange(mt.shape[0], mt.device)
    w, b = mt_bit(line)
    return ((mt[rows, row, w] >> b) & 1) != 0


def mt_update(mt, row: int, line, mask, set_val: bool) -> None:
    """Set or clear the line's bucket bit of bitmap `row` where mask, in
    place (per-lane rows are unique)."""
    rows = arange(mt.shape[0], mt.device)
    w, b = mt_bit(line)
    cur = mt[rows, row, w]
    new = (cur | (1 << b)) if set_val else (cur & ~(1 << b))
    mt[rows, row, w] = torch.where(mask, new, cur)


def mt_same_bucket(a, b):
    m = MT_BITS - 1
    return ((a.to(torch.int64) & U32 & m) == (b.to(torch.int64) & U32 & m))


# --- the record's memory slots ---------------------------------------------

def slots_present(mp: MemParams, op, flags, enabled) -> torch.Tensor:
    """bool[T, 3]: which of [icache, mem0, mem1] the record carries."""
    is_instr = (op < 15) | (op == int(Op.BBLOCK))
    icache = is_instr & enabled & bool(mp.icache_modeling)
    mem0 = (flags & FLAG_MEM0_VALID) != 0
    mem1 = (flags & FLAG_MEM1_VALID) != 0
    return torch.stack([icache, mem0, mem1], dim=1)


def next_present_slot(present, slot) -> torch.Tensor:
    """First present slot index >= slot, else 3 (int32)."""
    k = torch.arange(3, device=present.device)[None, :]
    cand = torch.where(present & (k >= slot[:, None]), k, 3)
    return cand.min(dim=1).values.to(torch.int32)


# --- per-call timing constants ---------------------------------------------

def _per_tile(v, device):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.astype(np.int64)).to(device)
    return int(v)


@dataclasses.dataclass
class MemTiming:
    """The cycle counts a call converts at each tile's frequency (ints, or
    int64[T] for heterogeneous geometries), and the directory-side times
    in ps at the DIRECTORY frequency (before the models-enabled gate)."""

    l1i_dat: object
    l1i_tag: object
    l1d_dat: object
    l1d_tag: object
    l2_dat: object
    l2_tag: object
    sync_core_l1d: int
    sync_core_l1i: int
    sync_l1d_l2: int
    sync_l1i_l2: int
    sync_l2_net: int
    dram_lat_ps: int
    dir_access_ps: int
    sync_dir_l2_ps: int
    sync_dir_net_ps: int
    trap_ps: int             # `[limitless] software_trap_penalty`

    @classmethod
    def build(cls, mp: MemParams, device) -> "MemTiming":
        def dps(n):
            return int(cycles_to_ps(int(n), mp.dir_freq_mhz))

        return cls(
            l1i_dat=_per_tile(mp.l1i.data_and_tags_cycles, device),
            l1i_tag=_per_tile(mp.l1i.tags_cycles, device),
            l1d_dat=_per_tile(mp.l1d.data_and_tags_cycles, device),
            l1d_tag=_per_tile(mp.l1d.tags_cycles, device),
            l2_dat=_per_tile(mp.l2.data_and_tags_cycles, device),
            l2_tag=_per_tile(mp.l2.tags_cycles, device),
            sync_core_l1d=mp.sync_cycles(MOD_CORE, MOD_L1D),
            sync_core_l1i=mp.sync_cycles(MOD_CORE, MOD_L1I),
            sync_l1d_l2=mp.sync_cycles(MOD_L1D, MOD_L2),
            sync_l1i_l2=mp.sync_cycles(MOD_L1I, MOD_L2),
            sync_l2_net=mp.sync_cycles(MOD_L2, MOD_NET_MEM),
            dram_lat_ps=(mp.dram_latency_ns + mp.dram_processing_ns) * 1000,
            dir_access_ps=dps(mp.dir_access_cycles),
            sync_dir_l2_ps=dps(mp.sync_cycles(MOD_DIR, MOD_L2)),
            sync_dir_net_ps=dps(mp.sync_cycles(MOD_DIR, MOD_NET_MEM)),
            trap_ps=dps(mp.limitless_trap_cycles),
        )

    def cycle_table(self, n_tiles: int, device) -> torch.Tensor:
        """int64[T, 11] of the per-tile cycle counts, in `CYC_*` order
        (the kernels' copy of the fields above)."""
        cols = [self.l1i_dat, self.l1i_tag, self.l1d_dat, self.l1d_tag,
                self.l2_dat, self.l2_tag, self.sync_core_l1d,
                self.sync_core_l1i, self.sync_l1d_l2, self.sync_l1i_l2,
                self.sync_l2_net]
        out = torch.empty((n_tiles, len(cols)), dtype=torch.int64,
                          device=device)
        for j, c in enumerate(cols):
            out[:, j] = c
        return out


def ccycles(n, fmhz, enabled):
    """cycles -> ps at each tile's frequency, 0 while models are off (a
    Python int `n` makes no host-to-device copy: the CUDA graphs of the
    plain phases call it)."""
    if not isinstance(n, int):
        n = torch.as_tensor(n, dtype=torch.int64, device=fmhz.device)
    return torch.where(enabled, cycles_to_ps(n, fmhz), 0)


def gated(ps: int, enabled) -> torch.Tensor:
    return torch.where(enabled, ps, 0).to(torch.int64)
