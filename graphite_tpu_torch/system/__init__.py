"""System services around the engine: checkpoints, statistics, the log.

Port of `graphite_tpu/system/__init__.py`'s exports.  A checkpoint is the
state's leaves in the JAX package's npz layout, so either package resumes
the other's; the statistics traces come from the chunked sampler
(`run_chunk` between samples); `Simulator.write_output` writes `sim.out`.
"""

from graphite_tpu_torch.system.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from graphite_tpu_torch.system.log import Log
from graphite_tpu_torch.system.statistics import StatisticsManager

__all__ = [
    "Log",
    "StatisticsManager",
    "load_checkpoint",
    "save_checkpoint",
]
