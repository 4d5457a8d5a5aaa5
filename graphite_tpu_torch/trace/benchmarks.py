"""SPLASH-2 FFT and RADIX trace programs.

Port of `graphite_tpu/trace/benchmarks.py` `fft_trace`: a six-step FFT
skeleton — BARRIER_INIT, then three all-to-all transposes (tile t sends
to t+i, then receives from t-i, for every i), two butterfly passes as
BBLOCK records, barrier waits between phases.  Butterfly cost: ~6 ops
per point per log2 stage (the JAX package's capture calibration).  With
`use_memory`, each butterfly pass first loads min(points, 32) lines of
the tile's private array (cold, line-disjoint between tiles), and only
tile 0 initializes the barrier, as in the JAX package's record-by-record
builder.  Both forms are bit-equal to the JAX package's arrays; the
memory form is assembled from columns here (the record-by-record form
is O(T^2) appends at 1024 tiles).

`radix_trace` is `graphite_tpu/trace/benchmarks.py:132-183`, record by
record: four digit passes, each a histogram, a log-tree prefix sum (up
and down sweeps of point-to-point messages) and a permutation with an
all-to-all key exchange, barriers between the phases.
"""

from __future__ import annotations

import numpy as np

from graphite_tpu_torch.trace.schema import (
    _FIELDS, FLAG_MEM0_VALID, FLAG_SIMPLE_MOV_LOAD, NO_REG, Op, TraceBatch,
    TraceBuilder,
)
from graphite_tpu_torch.trace.synthetic import _batch_from_columns


def fft_trace(n_tiles: int, points_per_tile: int = 256,
              use_memory: bool = False,
              ops_per_point_per_stage: int = 6) -> TraceBatch:
    stages = max(1, int(np.log2(max(2, points_per_tile))))
    fly_instr = points_per_tile * stages * ops_per_point_per_stage
    msg_bytes = max(8, (points_per_tile // max(1, n_tiles)) * 16)
    if use_memory:
        return _fft_trace_with_memory(n_tiles, points_per_tile, fly_instr,
                                      msg_bytes)

    T = n_tiles
    t = np.arange(T, dtype=np.int64)[:, None]
    i = np.arange(1, T, dtype=np.int64)[None, :]

    def col(op, aux0, aux1):
        return (np.full((T, 1), int(op), np.uint8),
                np.broadcast_to(np.asarray(aux0, np.int64), (T, 1)),
                np.full((T, 1), aux1, np.int64))

    ops, a0s, a1s = [], [], []

    def emit(op_block, aux0_block, aux1_block):
        ops.append(op_block)
        a0s.append(aux0_block)
        a1s.append(aux1_block)

    emit(*col(Op.BARRIER_INIT, np.zeros((T, 1)), T))
    a2a_send = (np.full((T, T - 1), int(Op.SEND), np.uint8),
                (t + i) % T, np.full((T, T - 1), msg_bytes, np.int64))
    a2a_recv = (np.full((T, T - 1), int(Op.NET_RECV), np.uint8),
                (t - i) % T, np.full((T, T - 1), msg_bytes, np.int64))
    for phase in range(3):
        emit(*col(Op.BARRIER_WAIT, np.zeros((T, 1)), 0))
        emit(*a2a_send)
        emit(*a2a_recv)
        if phase < 2:
            emit(*col(Op.BBLOCK, np.full((T, 1), fly_instr), fly_instr))
    emit(*col(Op.BARRIER_WAIT, np.zeros((T, 1)), 0))
    return _batch_from_columns(
        np.concatenate(ops, axis=1),
        aux0=np.concatenate(a0s, axis=1),
        aux1=np.concatenate(a1s, axis=1),
    )


def _fft_trace_with_memory(n_tiles: int, points_per_tile: int,
                           fly_instr: int, msg_bytes: int) -> TraceBatch:
    """The JAX package's `_fft_trace_with_memory` as columns: tile 0 leads
    with BARRIER_INIT, every tile ends with THREAD_EXIT, and the other
    tiles, one record shorter, pad with a NOP."""
    T = n_tiles
    K = min(points_per_tile, 32)
    t = np.arange(T, dtype=np.int64)[:, None]
    i = np.arange(1, T, dtype=np.int64)[None, :]
    j = np.arange(K, dtype=np.int64)[None, :]
    cols = {name: [] for name, _ in _FIELDS}

    def emit(op, width, **fields):
        cols["op"].append(np.full((T, width), int(op), np.int64))
        for name, _ in _FIELDS:
            if name == "op":
                continue
            fill = NO_REG if name in ("rreg0", "rreg1", "wreg") else 0
            v = fields.get(name, fill)
            cols[name].append(np.broadcast_to(np.asarray(v, np.int64),
                                              (T, width)))

    for phase in range(3):
        emit(Op.BARRIER_WAIT, 1)
        emit(Op.SEND, T - 1, aux0=(t + i) % T, aux1=msg_bytes)
        emit(Op.NET_RECV, T - 1, aux0=(t - i) % T, aux1=msg_bytes)
        if phase < 2:
            emit(Op.MOV, K, flags=FLAG_MEM0_VALID | FLAG_SIMPLE_MOV_LOAD,
                 addr0=t * points_per_tile * 64 + j * 64, size0=4)
            emit(Op.BBLOCK, 1, aux0=fly_instr, aux1=fly_instr)
    emit(Op.BARRIER_WAIT, 1)
    emit(Op.THREAD_EXIT, 1)
    body = {name: np.concatenate(cols[name], axis=1) for name, _ in _FIELDS}
    L = body["op"].shape[1] + 1
    out = {}
    for name, dtype in _FIELDS:
        a = np.zeros((T, L), np.int64)
        a[:] = NO_REG if name in ("rreg0", "rreg1", "wreg") else 0
        if name == "op":
            a[:] = int(Op.NOP)
        a[0, 1:] = body[name][0]
        a[1:, :-1] = body[name][1:]
        out[name] = a.astype(dtype)
    out["op"][0, 0] = int(Op.BARRIER_INIT)
    out["aux1"][0, 0] = T
    return TraceBatch(**out)


def radix_trace(n_tiles: int, keys_per_tile: int = 1024,
                radix: int = 16) -> TraceBatch:
    """Radix sort (SPLASH-2 radix.C structure), with the JAX package's
    per-key costs: ~2 records a key in the histogram, ~4 in the
    permutation."""
    T = n_tiles
    builders = [TraceBuilder() for _ in range(T)]
    builders[0].barrier_init(0, T)

    def barrier():
        for b in builders:
            b.barrier_wait(0)

    digits = max(1, 32 // max(1, int(np.log2(radix))))
    levels = max(1, int(np.log2(max(2, T))))
    a2a_bytes = max(8, keys_per_tile * 4 // max(1, T))
    for _ in range(min(digits, 4)):
        for b in builders:
            b.bblock(keys_per_tile * 2 + radix, keys_per_tile * 2 + radix)
        barrier()
        for lvl in range(levels):
            stride = 1 << lvl
            for t, b in enumerate(builders):
                if t % (stride * 2) == 0 and t + stride < T:
                    b.recv(t + stride, radix * 4)
                elif t % (stride * 2) == stride:
                    b.send(t - stride, radix * 4)
            for b in builders:
                b.bblock(radix, radix)
        for lvl in reversed(range(levels)):
            stride = 1 << lvl
            for t, b in enumerate(builders):
                if t % (stride * 2) == 0 and t + stride < T:
                    b.send(t + stride, radix * 4)
                elif t % (stride * 2) == stride:
                    b.recv(t - stride, radix * 4)
        barrier()
        for b in builders:
            b.bblock(keys_per_tile * 4, keys_per_tile * 4)
        for t, b in enumerate(builders):
            for i in range(1, T):
                b.send((t + i) % T, a2a_bytes)
            for i in range(1, T):
                b.recv((t - i) % T, a2a_bytes)
        barrier()
    return TraceBatch.from_builders(builders)
