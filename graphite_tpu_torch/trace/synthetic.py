"""Synthetic trace programs: the compute+message ring (vectorized).

Port of the parts of `graphite_tpu/trace/synthetic.py` this package's path
uses: the traffic-pattern destination schedules of the reference's
synthetic_network generator (`synthetic_network.cc:16-25,215-341`), the
vectorized column assembler, `message_ring_batch`,
`memory_stress_trace` and the ping-pong microbenchmark
(`ping_pong_trace`, BASELINE.json config 1).  Arrays are numpy, bit-equal
to the JAX package's builders.
"""

from __future__ import annotations

import numpy as np

from graphite_tpu_torch.models.network_emesh import (
    is_tile_count_permissible, mesh_dims,
)
from graphite_tpu_torch.trace.schema import (
    _FIELDS, FLAG_MEM0_VALID, FLAG_MEM0_WRITE, FLAG_SIMPLE_MOV_LOAD, NO_REG,
    Op, TraceBatch, TraceBuilder,
)


def _mesh_dims(n_tiles: int) -> tuple[int, int]:
    if not is_tile_count_permissible(n_tiles):
        raise ValueError("synthetic mesh patterns need w*h tile counts")
    return mesh_dims(n_tiles)


def uniform_random_matrix(n_tiles: int) -> np.ndarray:
    """The reference's LCG permutation schedule (`synthetic_network.cc:
    235-286`), [n_slots=n_tiles, n_senders=n_tiles]."""
    n = n_tiles
    send = np.zeros((n, n), dtype=np.int32)
    send[0][0] = n // 2
    for i in range(n):
        if i != 0:
            send[i][0] = send[i - 1][1]
        for j in range(1, n):
            send[i][j] = (13 * send[i][j - 1] + 5) % n
    return send


def destinations(pattern: str, n_tiles: int) -> np.ndarray:
    """Per-tile destination schedule, shape [n_slots, n_tiles]."""
    tile = np.arange(n_tiles, dtype=np.int32)
    if pattern == "uniform_random":
        return uniform_random_matrix(n_tiles)
    if pattern == "bit_complement":
        if n_tiles & (n_tiles - 1):
            raise ValueError("bit_complement needs a power-of-2 tile count")
        return (~tile & (n_tiles - 1))[None, :]
    if pattern == "shuffle":
        if n_tiles & (n_tiles - 1):
            raise ValueError("shuffle needs a power-of-2 tile count")
        nbits = n_tiles.bit_length() - 1
        return (((tile >> (nbits - 1)) & 1)
                | ((tile << 1) & (n_tiles - 1)))[None, :]
    w, h = _mesh_dims(n_tiles)
    sx, sy = tile % w, tile // w
    if pattern == "transpose":
        return (sx * w + sy)[None, :]
    if pattern == "tornado":
        return (((sy + h // 2) % h) * w + ((sx + w // 2) % w))[None, :]
    if pattern == "nearest_neighbor":
        return (((sy + 1) % h) * w + ((sx + 1) % w))[None, :]
    raise ValueError(f"unknown traffic pattern: {pattern}")


def _batch_from_columns(op, *, flags=None, pc=None, aux0=None, aux1=None,
                        dyn_ps=None) -> TraceBatch:
    """Assemble a TraceBatch from [n_tiles, L] numpy columns, appending
    one THREAD_EXIT column."""
    n, L = op.shape
    op = np.concatenate(
        [op, np.full((n, 1), int(Op.THREAD_EXIT), np.uint8)], axis=1)

    def pad(col, dtype, fill=0):
        if col is None:
            return np.full((n, L + 1), fill, dtype)
        return np.concatenate([col.astype(dtype),
                               np.full((n, 1), fill, dtype)], axis=1)

    return TraceBatch(
        op=op.astype(np.uint8),
        flags=pad(flags, np.uint8),
        pc=pad(pc, np.uint32),
        addr0=pad(None, np.uint32),
        addr1=pad(None, np.uint32),
        size0=pad(None, np.uint8),
        size1=pad(None, np.uint8),
        aux0=pad(aux0, np.int32),
        aux1=pad(aux1, np.int32),
        dyn_ps=pad(dyn_ps, np.int64),
        rreg0=pad(None, np.uint16, NO_REG),
        rreg1=pad(None, np.uint16, NO_REG),
        wreg=pad(None, np.uint16, NO_REG),
    )


def message_ring_batch(
    n_tiles: int,
    n_rounds: int,
    compute_per_round: int = 16,
    packet_size: int = 8,
    pattern: str = "nearest_neighbor",
    seed: int = 0,
    compressed: bool = False,
    cycles_per_instr: int = 1,
) -> TraceBatch:
    """Compute+communicate rounds: `compute_per_round` ialu records (one
    BBLOCK when `compressed`), one send following the traffic pattern, one
    receive from whichever sender targets this tile."""
    dest = destinations(pattern, n_tiles)  # [n_slots, n_tiles]
    n_slots = dest.shape[0]
    senders = np.empty_like(dest)
    for s in range(n_slots):
        senders[s, dest[s]] = np.arange(n_tiles, dtype=dest.dtype)

    n_compute_recs = 1 if compressed else compute_per_round
    L_round = n_compute_recs + 2
    L = n_rounds * L_round
    op = np.full((n_tiles, L), int(Op.IALU), np.uint8)
    aux0 = np.zeros((n_tiles, L), np.int32)
    aux1 = np.zeros((n_tiles, L), np.int32)
    send_cols = np.arange(n_rounds) * L_round + n_compute_recs
    recv_cols = send_cols + 1
    rounds = np.arange(n_rounds)
    if compressed:
        bblock_cols = np.arange(n_rounds) * L_round
        op[:, bblock_cols] = int(Op.BBLOCK)
        aux0[:, bblock_cols] = compute_per_round
        aux1[:, bblock_cols] = compute_per_round * cycles_per_instr
    op[:, send_cols] = int(Op.SEND)
    op[:, recv_cols] = int(Op.NET_RECV)
    aux0[:, send_cols] = dest[rounds % n_slots].T
    aux0[:, recv_cols] = senders[rounds % n_slots].T
    aux1[:, send_cols] = packet_size
    aux1[:, recv_cols] = packet_size
    return _batch_from_columns(op, aux0=aux0, aux1=aux1)


def memory_stress_trace(
    n_tiles: int,
    n_accesses: int = 1000,
    working_set_bytes: int = 1 << 20,
    write_fraction: float = 0.3,
    stride: "int | None" = None,
    shared_fraction: float = 0.0,
    cache_line_size: int = 64,
    seed: int = 0,
) -> TraceBatch:
    """Random or strided 8-byte loads and stores (synthetic_memory analog):
    each tile touches its private working set at tile * working_set, plus,
    with `shared_fraction`, a shared region (coherence stress).

    The random draws come from one numpy Generator in the JAX package's
    order (per access: the offset unless strided, the shared draw when
    `shared_fraction` > 0, the store draw), so they stay scalar draws;
    the records are assembled as [T, n_accesses] columns."""
    rng = np.random.default_rng(seed)
    T, n = n_tiles, n_accesses
    shared_base = (n_tiles + 1) * working_set_bytes
    offset = np.zeros((T, n), np.int64)
    shared = np.zeros((T, n), bool)
    store = np.zeros((T, n), bool)
    for t in range(T):
        for i in range(n):
            if stride is not None:
                offset[t, i] = (i * stride) % working_set_bytes
            else:
                offset[t, i] = int(rng.integers(0, working_set_bytes // 8)) * 8
            shared[t, i] = (shared_fraction > 0
                            and rng.random() < shared_fraction)
            store[t, i] = rng.random() < write_fraction
    base = np.arange(T, dtype=np.int64)[:, None] * working_set_bytes
    addr = np.where(shared, shared_base + offset % (working_set_bytes // 4),
                    base + offset)
    addr -= addr % 8
    pc = 0x1000 + (np.arange(n) % 256) * 4
    out = {name: np.zeros((T, n + 1), dtype) for name, dtype in _FIELDS}
    out["op"][:, :n] = int(Op.MOV)
    out["op"][:, n] = int(Op.THREAD_EXIT)
    out["flags"][:, :n] = np.where(
        store, FLAG_MEM0_VALID | FLAG_MEM0_WRITE,
        FLAG_MEM0_VALID | FLAG_SIMPLE_MOV_LOAD)
    out["pc"][:, :n] = pc[None, :]
    out["addr0"][:, :n] = addr
    out["size0"][:, :n] = 8
    for f in ("rreg0", "rreg1", "wreg"):
        out[f][:] = NO_REG
    return TraceBatch(**out)


def ping_pong_trace(n_tiles: int = 2, n_rounds: int = 100,
                    packet_size: int = 8) -> TraceBatch:
    """tests/apps/ping_pong: tile 0 and 1 bounce a message back and forth
    (`graphite_tpu/trace/synthetic.py:187-198`); the other tiles idle."""
    if n_tiles < 2:
        raise ValueError("ping-pong needs at least two tiles")
    builders = [TraceBuilder() for _ in range(n_tiles)]
    for _ in range(n_rounds):
        builders[0].send(1, packet_size)
        builders[0].recv(1, packet_size)
        builders[1].recv(0, packet_size)
        builders[1].send(0, packet_size)
    return TraceBatch.from_builders(builders)
