"""Per-tile logging with module filters (`common/misc/log.{h,cc}`).

Port of `graphite_tpu/system/log.py` (host only).  The reference writes
one file per tile plus per-simthread files, with module-level
enable/disable filters and simulated timestamps (`log.h:34-47,63-67`;
knobs `carbon_sim.cfg:73-79`).  Here the step runs as device kernels —
per-instruction logging does not exist by construction — so the Log
serves the host orchestration layer: lifecycle events, quantum
boundaries, stats samples, and model summaries, with the same filter
knobs and a per-tile file layout.  Disabled logging costs one predicate
check (the reference compiles it out under NDEBUG; `log.h:84-90`).
"""

from __future__ import annotations

import os
import time


class Log:
    """`Log::getSingleton()`-style logger driven by the `[log]` section."""

    def __init__(self, cfg, output_dir: str = "logs", n_tiles: int = 0):
        self.enabled = cfg.get_bool("log/enabled", False)
        disabled = cfg.get_string("log/disabled_modules", "")
        enabled_mods = cfg.get_string("log/enabled_modules", "")
        self._disabled = {m.strip() for m in disabled.split(",") if m.strip()}
        self._enabled_only = {
            m.strip() for m in enabled_mods.split(",") if m.strip()
        }
        self._dir = output_dir
        self._files: dict = {}
        self._t0 = time.time()
        self._n_tiles = n_tiles
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)

    def is_logging_enabled(self, module: str) -> bool:
        if not self.enabled:
            return False
        if self._enabled_only:
            return module in self._enabled_only
        return module not in self._disabled

    def _file(self, tile_id: int):
        if tile_id not in self._files:
            name = ("system.log" if tile_id < 0
                    else f"tile_{tile_id}.log")
            self._files[tile_id] = open(
                os.path.join(self._dir, name), "a")
        return self._files[tile_id]

    def log(self, module: str, message: str, tile_id: int = -1,
            sim_time_ns: int | None = None) -> None:
        """`LOG_PRINT` analog: [elapsed][tile][sim-time][module] message."""
        if not self.is_logging_enabled(module):
            return
        f = self._file(tile_id)
        elapsed_ms = int((time.time() - self._t0) * 1000)
        st = "" if sim_time_ns is None else f"[{sim_time_ns}ns]"
        f.write(f"[{elapsed_ms}ms][{tile_id}]{st}[{module}] {message}\n")
        f.flush()

    def assert_error(self, condition: bool, module: str, message: str,
                     tile_id: int = -1) -> None:
        """`LOG_ASSERT_ERROR`: log + raise when the condition fails."""
        if not condition:
            self.log(module, f"ASSERT FAILED: {message}", tile_id)
            raise AssertionError(f"[{module}] {message}")

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
