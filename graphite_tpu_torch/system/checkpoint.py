"""Checkpoint/resume of simulation state, in the JAX package's layout.

Port of `graphite_tpu/system/checkpoint.py`: a checkpoint is a compressed
npz of the state's leaves, keyed by pytree path ("core||clock_ps", ...),
plus the quantum counter `__n_quanta__`.  The keys and dtypes are the
JAX package's (`convert.checkpoint_arrays`), so a checkpoint saved by
either package loads into the other's Simulator built from the same
config and trace, and the resumed run finishes bit-equal to an
uninterrupted one.  One exception: the port keeps no `mem||phase_skips`
for the private-L2 engine (the JAX engine's count of memory phases it
skipped, a statistic only) and saves it as zeros, so a JAX run resumed
from the port's checkpoint counts its phase skips from zero; every other
leaf and result is equal.  The shared-L2 engine's skip counts are the
port's own leaf (counted on the CPU path) and are saved as they are.
"""

from __future__ import annotations

import numpy as np

from graphite_tpu_torch.convert import (
    checkpoint_arrays, checkpoint_layout, state_from_checkpoint,
)


def save_checkpoint(sim, path: str, n_quanta: int = 0) -> None:
    """Write the Simulator's current state (+ progress marker) to `path`."""
    leaves = checkpoint_arrays(sim.state)
    leaves["__n_quanta__"] = np.asarray(n_quanta)
    np.savez_compressed(path, **leaves)


def load_checkpoint(sim, path: str) -> int:
    """Restore state saved by save_checkpoint (this package's or the JAX
    package's) into a Simulator built from the SAME config and trace.
    Returns the saved quantum counter.  Raises ValueError when a leaf of
    the Simulator's state is missing from the file or has another
    shape."""
    want = checkpoint_layout(sim.state)
    with np.load(path) as data:
        arrays = {}
        for key, (shape, dtype) in want.items():
            if key not in data:
                raise ValueError(
                    f"checkpoint missing leaf {key!r} — was it saved from "
                    "a different config/topology?")
            arr = data[key]
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape} != "
                    f"state shape {shape}")
            # only the leaves this state has (a JAX file holds more, such
            # as its per-phase skip counters), each with the JAX dtype
            arrays[key] = arr.astype(dtype, copy=False)
        n_quanta = int(data["__n_quanta__"])
    sim.state = state_from_checkpoint(arrays, sim.device)
    return n_quanta
