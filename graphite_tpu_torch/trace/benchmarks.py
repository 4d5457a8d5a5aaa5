"""SPLASH-2 / PARSEC trace programs: every generator of the JAX package.

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

The other generators (`blackscholes_trace` and `canneal_trace`, the
BASELINE.json workloads; `lu`, `ocean`, `barnes`, `water-nsquared`,
`cholesky`, `water-spatial`, `volrend`, `raytrace`, `radiosity`, `fmm`)
are `graphite_tpu/trace/benchmarks.py:186-599` record by record, each
random draw in the JAX order (a vectorised draw would change the
trace).  `BENCHMARKS` maps `bench.py`'s workload names to them.
"""

from __future__ import annotations

import numpy as np

from graphite_tpu_torch.trace.schema import (
    _FIELDS, FLAG_MEM0_VALID, FLAG_SIMPLE_MOV_LOAD, NO_REG, Op, TraceBatch,
    TraceBuilder,
)
from graphite_tpu_torch.trace.synthetic import _batch_from_columns


# All the record-by-record generators below use barrier id 0 (one barrier
# per app run, reused).
_BAR = 0


def _all_to_all_phase(builders, n_tiles, bytes_per_msg):
    """Tile t sends one message to every other tile, then receives one
    from every other tile — the transpose/permutation skeleton."""
    for t, b in enumerate(builders):
        for i in range(1, n_tiles):
            b.send((t + i) % n_tiles, bytes_per_msg)
        for i in range(1, n_tiles):
            b.recv((t - i) % n_tiles, bytes_per_msg)


def _barrier(builders):
    for b in builders:
        b.barrier_wait(_BAR)


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
    builders[0].barrier_init(_BAR, T)
    digits = max(1, 32 // max(1, int(np.log2(radix))))
    levels = max(1, int(np.log2(max(2, T))))
    for _ in range(min(digits, 4)):
        for b in builders:
            b.bblock(keys_per_tile * 2 + radix, keys_per_tile * 2 + radix)
        _barrier(builders)
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
        _barrier(builders)
        for b in builders:
            b.bblock(keys_per_tile * 4, keys_per_tile * 4)
        _all_to_all_phase(builders, T, max(8, keys_per_tile * 4 // T))
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def blackscholes_trace(n_tiles: int, options_per_tile: int = 512,
                       sweeps: int = 4) -> TraceBatch:
    """Embarrassingly parallel pricing: ~200 fp ops per option (CNDF +
    exp/log/sqrt approximations), one barrier per sweep (PARSEC
    blackscholes.c bs_thread loop)."""
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    per_sweep = options_per_tile * 200
    for s in range(sweeps):
        for b in builders:
            b.bblock(per_sweep, per_sweep)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def canneal_trace(n_tiles: int, footprint_lines: int = 4096,
                  swaps_per_tile: int = 64, seed: int = 1234,
                  use_memory: bool = True) -> TraceBatch:
    """Simulated-annealing element swaps: random-access loads over a large
    shared footprint (cache-hostile), ~60 int/fp ops to evaluate each swap,
    a taken/not-taken accept branch, and occasional stores (PARSEC canneal
    netlist swap loop)."""
    rng = np.random.default_rng(seed)
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    for t, b in enumerate(builders):
        for s in range(swaps_per_tile):
            if use_memory:
                a1 = int(rng.integers(footprint_lines)) * 64
                a2 = int(rng.integers(footprint_lines)) * 64
                b.load(a1)
                b.load(a2)
            b.bblock(60, 60)
            b.branch(bool(rng.integers(2)), pc=s & 0x3FF)
            if use_memory and rng.random() < 0.3:
                b.store(int(rng.integers(footprint_lines)) * 64)
    _barrier(builders)
    return TraceBatch.from_builders(builders)


BENCHMARKS = {
    "fft": fft_trace,
    "radix": radix_trace,
    "blackscholes": blackscholes_trace,
    "canneal": canneal_trace,
}


def lu_trace(n_tiles: int, blocks_per_side: int | None = None,
             block: int = 16, use_memory: bool = False) -> TraceBatch:
    """Blocked dense LU factorization (SPLASH-2 `kernels/lu/lu.C`):
    block-cyclic ownership; step k factorizes the diagonal block
    (~B^3/3 fp), updates the k-th row/column perimeter blocks (~B^3),
    then the interior trailing submatrix (~2B^3 per block), with a
    barrier between the three sub-phases (lu.C OneSolve loop).  With
    use_memory, perimeter/interior owners load the diagonal block's
    lines — the read-sharing the shared-memory original exhibits.

    fp structure VALIDATED against a real captured execution
    (`tools/capture.py lu` — an actual blocked fixed-point LU recorded
    under the Carbon API, L@U reconstruction error 7e-5): the capture
    measured 21,408 fp records where this model charges 21,160 for the
    same (n=32, B=8, 4-tile) run — within 1.2%, so the per-phase B^3
    coefficients stand (PERF.md "Trace-capture calibration")."""
    if blocks_per_side is None:
        blocks_per_side = max(2, int(np.sqrt(n_tiles)))
    N = blocks_per_side
    fp3 = block * block * block
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)

    def owner(i, j):
        return (i * N + j) % n_tiles

    for k in range(N):
        diag = owner(k, k)
        builders[diag].bblock(fp3 // 3, fp3 // 3)
        _barrier(builders)
        diag_base = (k * N + k) * block * block * 8
        for j in range(k + 1, N):
            for (bi, bj) in ((k, j), (j, k)):
                t = owner(bi, bj)
                if use_memory:
                    for ln in range(min(block, 8)):
                        builders[t].load(diag_base + ln * 64)
                builders[t].bblock(fp3, fp3)
        _barrier(builders)
        for i in range(k + 1, N):
            for j in range(k + 1, N):
                builders[owner(i, j)].bblock(2 * fp3, 2 * fp3)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def ocean_trace(n_tiles: int, rows_per_tile: int = 64, cols: int = 64,
                iterations: int = 4) -> TraceBatch:
    """Ocean current simulation (SPLASH-2 `apps/ocean`): red-black
    Gauss-Seidel relaxation over a partitioned grid — each iteration a
    ~7-fp-op 5-point stencil sweep over the tile's rows, boundary-row
    exchange with the up/down neighbors, and a barrier (ocean's
    relax/jacobcalc loops)."""
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    sweep = rows_per_tile * cols * 7
    row_bytes = cols * 8
    for it in range(iterations):
        for t, b in enumerate(builders):
            b.bblock(sweep, sweep)
        # boundary exchange: down then up (edge tiles skip the absent side)
        for t, b in enumerate(builders):
            if t + 1 < n_tiles:
                b.send(t + 1, row_bytes)
            if t > 0:
                b.send(t - 1, row_bytes)
        for t, b in enumerate(builders):
            if t > 0:
                b.recv(t - 1, row_bytes)
            if t + 1 < n_tiles:
                b.recv(t + 1, row_bytes)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def barnes_trace(n_tiles: int, bodies_per_tile: int = 64,
                 steps: int = 2, seed: int = 7,
                 use_memory: bool = False) -> TraceBatch:
    """Barnes-Hut N-body (SPLASH-2 `apps/barnes`): per timestep a
    tree-build phase (integer-heavy, irregular — maketree) behind a
    barrier, then force computation per body (~log N cell visits x ~20 fp
    ops — hackgrav) with irregular loads over the shared tree, then a
    position update sweep (grav.C/code.C stepsystem structure)."""
    rng = np.random.default_rng(seed)
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    logn = max(1, int(np.log2(max(2, n_tiles * bodies_per_tile))))
    for s in range(steps):
        for b in builders:
            b.bblock(bodies_per_tile * 8, bodies_per_tile * 8)  # maketree
        _barrier(builders)
        for t, b in enumerate(builders):
            for body in range(min(bodies_per_tile, 16)):
                if use_memory:
                    # ~logn tree-cell touches over a shared footprint
                    for v in range(min(logn, 4)):
                        b.load(int(rng.integers(1 << 14)) * 64)
                b.bblock(logn * 20, logn * 20)
            rem = bodies_per_tile - min(bodies_per_tile, 16)
            if rem > 0:
                b.bblock(rem * logn * 20, rem * logn * 20)
        _barrier(builders)
        for b in builders:
            b.bblock(bodies_per_tile * 6, bodies_per_tile * 6)  # advance
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def water_nsquared_trace(n_tiles: int, molecules_per_tile: int = 32,
                         steps: int = 2) -> TraceBatch:
    """Water-NSquared molecular dynamics (SPLASH-2
    `apps/water-nsquared`): per timestep intra-molecule force updates,
    the O(n^2/2) inter-molecule pair sweep (~250 fp ops per pair —
    interf), and a mutex-protected global virial/energy accumulation
    (water.C mdmain loop; the global sum uses a lock in the original)."""
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    builders[0].mutex_init(0)
    _barrier(builders)
    n_total = molecules_per_tile * n_tiles
    pairs = molecules_per_tile * max(1, n_total // 2) // 64
    for s in range(steps):
        for b in builders:
            b.bblock(molecules_per_tile * 40, molecules_per_tile * 40)
        _barrier(builders)
        for b in builders:
            b.bblock(pairs * 250, pairs * 250)
        for b in builders:
            b.mutex_lock(0)
            b.bblock(20, 20)
            b.mutex_unlock(0)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def cholesky_trace(n_tiles: int, supernodes: int | None = None,
                   block: int = 16) -> TraceBatch:
    """Sparse Cholesky factorization (SPLASH-2 `kernels/cholesky`):
    supernode task queue — each supernode's owner factorizes it
    (~B^3/3 fp) and sends updates to the owners of affected later
    supernodes (task-queue puts), which fold them in (~B^2 fp per
    update).  The skeleton serializes dependency chains with
    point-to-point messages instead of the original's task-queue locks."""
    if supernodes is None:
        supernodes = max(4, n_tiles // 2)
    fp3 = block * block * block
    fp2 = block * block
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    for sn in range(supernodes):
        t = sn % n_tiles
        builders[t].bblock(fp3 // 3, fp3 // 3)
        # updates fan out to the next up-to-3 supernodes' owners
        targets = [(sn + d) % supernodes for d in (1, 2, 3)
                   if sn + d < supernodes]
        for d in targets:
            to = d % n_tiles
            if to != t:
                builders[t].send(to, fp2 * 8)
        for d in targets:
            to = d % n_tiles
            if to != t:
                builders[to].recv(t, fp2 * 8)
                builders[to].bblock(fp2 * 4, fp2 * 4)
    _barrier(builders)
    return TraceBatch.from_builders(builders)


BENCHMARKS.update({
    "lu": lu_trace,
    "ocean": ocean_trace,
    "barnes": barnes_trace,
    "water-nsquared": water_nsquared_trace,
    "cholesky": cholesky_trace,
})


def water_spatial_trace(n_tiles: int, molecules_per_tile: int = 32,
                        steps: int = 2) -> TraceBatch:
    """Water-Spatial molecular dynamics (SPLASH-2 `apps/water-spatial`):
    the O(n) spatial variant of water — molecules live in 3D cells, each
    tile owns a cell block; per timestep: intra-molecule updates, pair
    forces against molecules in NEIGHBORING cells only (~250 fp ops per
    pair, half the 26-neighborhood by Newton's 3rd law — here the mesh
    neighbor ring carries the boundary-molecule exchange), and the same
    mutex-protected global virial accumulation as water-nsquared
    (water-spatial's interf/bndry loops)."""
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    builders[0].mutex_init(0)
    _barrier(builders)
    # neighbor pairs only: O(molecules * local density), not O(n^2)
    pairs = molecules_per_tile * 8
    boundary_bytes = max(8, molecules_per_tile // 4 * 72)  # 9 doubles/mol
    for s in range(steps):
        for b in builders:
            b.bblock(molecules_per_tile * 40, molecules_per_tile * 40)
        # boundary-cell molecule exchange with the ±1 mesh neighbors
        for t, b in enumerate(builders):
            b.send((t + 1) % n_tiles, boundary_bytes)
            b.send((t - 1) % n_tiles, boundary_bytes)
        for t, b in enumerate(builders):
            b.recv((t - 1) % n_tiles, boundary_bytes)
            b.recv((t + 1) % n_tiles, boundary_bytes)
        for b in builders:
            b.bblock(pairs * 250, pairs * 250)
        for b in builders:
            b.mutex_lock(0)
            b.bblock(20, 20)
            b.mutex_unlock(0)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def volrend_trace(n_tiles: int, rays_per_tile: int = 128,
                  frames: int = 2, seed: int = 21,
                  use_memory: bool = False) -> TraceBatch:
    """Volume rendering (SPLASH-2 `apps/volrend`): per frame each tile
    ray-casts its image block — ~30 fp ops per sample, with early
    termination modeled by drawing an adaptive length (4–16 samples) for
    each of the first 16 rays; the remaining rays are lumped into one
    block at the 10-sample average (keeps trace records bounded), and
    irregular loads over the shared volume when use_memory; frames end
    at a barrier after a mutex-protected image merge (volrend's
    render/ray loops + the task-queue lock)."""
    rng = np.random.default_rng(seed)
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    builders[0].mutex_init(0)
    _barrier(builders)
    for f in range(frames):
        for t, b in enumerate(builders):
            lens = rng.integers(4, 17, size=min(rays_per_tile, 16))
            for ray, ln in enumerate(lens):
                if use_memory:
                    b.load(int(rng.integers(1 << 14)) * 64)
                b.bblock(int(ln) * 30, int(ln) * 30)
            rem = rays_per_tile - len(lens)
            if rem > 0:
                b.bblock(rem * 10 * 30, rem * 10 * 30)
        for b in builders:
            b.mutex_lock(0)
            b.bblock(16, 16)
            b.mutex_unlock(0)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def raytrace_trace(n_tiles: int, rays_per_tile: int = 128,
                   seed: int = 33, use_memory: bool = False) -> TraceBatch:
    """Ray tracing (SPLASH-2 `apps/raytrace`): a single frame of primary
    rays over image tiles — per ray a BSP-tree walk (~log-depth cell
    visits x ~40 fp intersection ops); tree depth (2–8) is drawn for
    each of the first 16 rays to model the irregular secondary-ray
    fan-out, the remaining rays lumped into one block at the depth-5
    average (keeps trace records bounded), with irregular
    shared-geometry loads; work stealing (raytrace's GetJobs/PutJobs)
    is modeled as a mutex-protected queue touch every 32 modeled rays —
    with the 16-ray cap that is one touch per tile, the lumped
    remainder carrying none."""
    rng = np.random.default_rng(seed)
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    builders[0].mutex_init(0)
    _barrier(builders)
    for t, b in enumerate(builders):
        depths = rng.integers(2, 9, size=min(rays_per_tile, 16))
        for ray, d in enumerate(depths):
            if ray % 32 == 0:
                b.mutex_lock(0)
                b.bblock(10, 10)
                b.mutex_unlock(0)
            if use_memory:
                b.load(int(rng.integers(1 << 14)) * 64)
            b.bblock(int(d) * 40, int(d) * 40)
        rem = rays_per_tile - len(depths)
        if rem > 0:
            b.bblock(rem * 5 * 40, rem * 5 * 40)
    _barrier(builders)
    return TraceBatch.from_builders(builders)


def radiosity_trace(n_tiles: int, patches_per_tile: int = 32,
                    iterations: int = 2, seed: int = 55) -> TraceBatch:
    """Hierarchical radiosity (SPLASH-2 `apps/radiosity`): per iteration
    each tile refines its patch interactions — ~60 fp ops per form-factor
    + visibility test, patch counts drawn per tile for the strong load
    imbalance the original exhibits — then distributes energy updates to
    other patch owners (task-queue puts, modeled as point-to-point sends
    to a random owner) behind a mutex; iterations end at a barrier
    (radiosity's process_tasks loop)."""
    rng = np.random.default_rng(seed)
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    builders[0].mutex_init(0)
    _barrier(builders)
    for it in range(iterations):
        counts = rng.integers(patches_per_tile // 2,
                              patches_per_tile * 2, size=n_tiles)
        tgt = [int(rng.integers(n_tiles)) for _ in range(n_tiles)]
        for t, b in enumerate(builders):
            b.bblock(int(counts[t]) * 60, int(counts[t]) * 60)
            b.mutex_lock(0)
            b.bblock(12, 12)
            b.mutex_unlock(0)
        # energy pushes: one update message to a random other owner,
        # mirrored receives keep the rendezvous deterministic
        for t, b in enumerate(builders):
            dst = tgt[t] if tgt[t] != t else (t + 1) % n_tiles
            b.send(dst, 64)
        recv_from = [[] for _ in range(n_tiles)]
        for t in range(n_tiles):
            dst = tgt[t] if tgt[t] != t else (t + 1) % n_tiles
            recv_from[dst].append(t)
        for t, b in enumerate(builders):
            for src in recv_from[t]:
                b.recv(src, 64)
            b.bblock(len(recv_from[t]) * 20 + 1, len(recv_from[t]) * 20 + 1)
        _barrier(builders)
    return TraceBatch.from_builders(builders)


def fmm_trace(n_tiles: int, bodies_per_tile: int = 64,
              multipole_terms: int = 4) -> TraceBatch:
    """Fast Multipole Method N-body (SPLASH-2 `apps/fmm`): per step —
    tree build (integer-heavy) | barrier | upward pass (multipole
    moments, ~p^2 fp per cell) | interaction lists: each cell's V-list
    multipole-to-local translations (~p^4 fp per interaction, exchanged
    with mesh-neighbor owners) | downward pass + near-field direct
    O(bodies x neighbors) | barrier (fmm's steps in interactions.C /
    construct_grid)."""
    p2 = multipole_terms * multipole_terms
    p4 = p2 * p2
    builders = [TraceBuilder() for _ in range(n_tiles)]
    builders[0].barrier_init(_BAR, n_tiles)
    cells = max(1, bodies_per_tile // 8)
    for b in builders:
        b.bblock(bodies_per_tile * 10, bodies_per_tile * 10)  # tree build
    _barrier(builders)
    for b in builders:
        b.bblock(cells * p2, cells * p2)                      # upward
    _barrier(builders)
    # V-list exchange: moments to/from the ±1, ±2 mesh neighbors
    mom_bytes = p2 * 16
    for off in (1, 2):
        for t, b in enumerate(builders):
            b.send((t + off) % n_tiles, mom_bytes)
        for t, b in enumerate(builders):
            b.recv((t - off) % n_tiles, mom_bytes)
    for b in builders:
        b.bblock(cells * 8 * p4, cells * 8 * p4)              # M2L
    _barrier(builders)
    near = bodies_per_tile * 9 * 20
    for b in builders:
        b.bblock(cells * p2 + near, cells * p2 + near)        # down + near
    _barrier(builders)
    return TraceBatch.from_builders(builders)


BENCHMARKS.update({
    "water-spatial": water_spatial_trace,
    "volrend": volrend_trace,
    "raytrace": raytrace_trace,
    "radiosity": radiosity_trace,
    "fmm": fmm_trace,
})
