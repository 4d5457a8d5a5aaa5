"""Time-sampled statistics traces (`common/system/statistics_manager.cc`).

Port of `graphite_tpu/system/statistics.py`, its chunked backend: the
simulation runs in chunks of `chunk_quanta` barrier quanta over
`Simulator.run_chunk`, and between chunks the sampler reads the state it
needs and appends records to the same `.trace` files as the JAX package:

 - `cache_line_replication`: how many tiles cache each distinct line, as
   a histogram, from the L2 tags;
 - `cache_line_utilization`: the classified L2 lines' access histogram;
 - `network_utilization_user` / `_memory`: per-interval injection rates,
   exact from the USER net's packet counters, approximated for the
   MEMORY net from the protocol counters;
 - `progress` (`pin/progress_trace.cc`): each tile's clock and record.

Not ported: the device-timeline backend (`backend="device"`, and `"auto"`
where the JAX package would pick it), which needs the telemetry ring
(ROADMAP.md queue 1, item 12), and the periodic power trace
(`[runtime_energy_modeling/power_trace]`, item 10).  Both raise
NotImplementedError naming their item.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def chunk_quanta(sampling_interval_ns: int, quantum_ps: int) -> int:
    """Quanta per sample: the sampling interval floor-divided by the
    barrier quantum, never below one quantum."""
    return max(1, (int(sampling_interval_ns) * 1000) // int(quantum_ps))


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to graphite_tpu_torch yet (ROADMAP.md "
        f"queue 1, item {item})")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class StatisticsManager:
    """Drives a Simulator in sampling-interval chunks, writing traces."""

    def __init__(self, sim, output_dir: str = "stats",
                 backend: str = "auto"):
        cfg = sim.config.cfg
        self.sim = sim
        self.enabled = cfg.get_bool("statistics_trace/enabled", False)
        stats = cfg.get_string(
            "statistics_trace/statistics",
            "cache_line_replication, network_utilization")
        self.types = {s.strip() for s in stats.split(",") if s.strip()}
        self.sampling_interval_ns = cfg.get_int(
            "statistics_trace/sampling_interval", 10000)
        self.progress_enabled = cfg.get_bool("progress_trace/enabled", False)
        self.power_enabled = cfg.get_bool(
            "runtime_energy_modeling/power_trace/enabled", False)
        if backend not in ("auto", "device", "chunked"):
            raise ValueError(f"unknown statistics backend {backend!r} "
                             "(expected 'auto', 'device' or 'chunked')")
        if backend == "device" and not self.device_supported():
            raise ValueError(
                "the device-timeline backend covers counter-derived "
                "statistics only (network_utilization under "
                "[statistics_trace]); replication/utilization histograms, "
                "per-tile progress rows and power sampling need live-state "
                "snapshots the telemetry carry cannot afford — use "
                "backend='chunked' (or 'auto') for those")
        if backend == "device" or (backend == "auto"
                                   and self.device_supported()):
            raise _not_ported("the device-timeline statistics backend "
                              "(the telemetry ring)", 12)
        if self.power_enabled:
            raise _not_ported("the periodic power trace "
                              "([runtime_energy_modeling/power_trace])", 10)
        self.out_dir = output_dir
        self._files: dict = {}
        self._prev_user_packets = 0.0
        self._prev_mem_msgs = 0.0
        self._prev_sample_ns = 0

    def device_supported(self) -> bool:
        """Whether the JAX package's `auto` would pick its device backend:
        every ENABLED statistic counter-derived (network utilization)."""
        if self.progress_enabled or self.power_enabled or not self.enabled:
            return False
        unsupported = self.types - {"network_utilization"}
        return not unsupported and "network_utilization" in self.types

    # -- trace files (`openTraceFiles`) ---------------------------------
    def _file(self, name: str):
        if name not in self._files:
            os.makedirs(self.out_dir, exist_ok=True)
            self._files[name] = open(
                os.path.join(self.out_dir, f"{name}.trace"), "w")
        return self._files[name]

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    # -- samplers --------------------------------------------------------
    def replication_histogram(self) -> np.ndarray:
        """hist[k] = number of distinct lines cached by exactly k + 1 tiles
        (k = 0..n_tiles - 1), from the L2 tags and states."""
        T = self.sim.params.n_tiles
        ms = self.sim.state.mem
        if ms is None:
            return np.zeros(T, np.int64)
        meta = _host(ms.l2.meta)
        valid = ((meta >> 8) & 0xFF) != 0      # INVALID == 0
        lines = (meta >> 16).astype(np.int32)[valid]
        if lines.size == 0:
            return np.zeros(T, np.int64)
        _, counts = np.unique(lines, return_counts=True)
        return np.bincount(counts, minlength=T + 1)[1:]

    def _memory_message_count(self, mem_counters) -> float:
        """Protocol messages ≈ 2x misses (req+rep) + 2x invalidations +
        evictions (approximation: the reference counts per-packet)."""
        if mem_counters is None:
            return 0.0
        return float(
            2 * mem_counters["l2_misses"].sum()
            + 2 * mem_counters["invalidations"].sum()
            + mem_counters["evictions"].sum())

    def _sim_time_ns(self) -> int:
        """The laggard non-done tile's clock, or the max clock when all
        tiles are done."""
        done = _host(self.sim.state.done)
        clocks = _host(self.sim.state.core.clock_ps)
        pending = clocks[~done]
        t = pending.min() if pending.size else clocks.max()
        return int(t) // 1000

    def _progress_row(self, time_ns: int) -> None:
        core = self.sim.state.core
        clocks, idx = _host(core.clock_ps), _host(core.idx)
        row = " ".join(f"{c // 1000}/{i}" for c, i in zip(clocks, idx))
        self._file("progress").write(f"{time_ns} {row}\n")

    def sample(self, time_ns: int) -> None:
        state = self.sim.state
        if not self.enabled:
            # [statistics_trace] enabled=false: only the independently
            # gated progress trace may write
            if self.progress_enabled:
                self._progress_row(time_ns)
            return
        if "cache_line_replication" in self.types and state.mem is not None:
            hist = self.replication_histogram()
            nz = np.flatnonzero(hist)
            row = " ".join(f"{k + 1}:{hist[k]}" for k in nz)
            self._file("cache_line_replication").write(
                f"{time_ns} {row}\n")
        if ("cache_line_utilization" in self.types and state.mem is not None
                and getattr(state.mem, "l2_util", None) is not None):
            hist = _host(state.mem.counters.line_util_hist).sum(axis=0)
            row = " ".join(f"{k}:{int(v)}" for k, v in enumerate(hist))
            self._file("cache_line_utilization").write(
                f"{time_ns} {row}\n")
        if "network_utilization" in self.types:
            T = max(self.sim.params.n_tiles, 1)
            interval_ns = max(time_ns - self._prev_sample_ns, 1)
            total = float(_host(state.net.packets_sent).sum())
            delta = total - self._prev_user_packets
            self._prev_user_packets = total
            self._file("network_utilization_user").write(
                f"{time_ns} {delta / interval_ns / T:.6f}\n")
            if state.mem is not None:
                counters = state.mem.counters
                mc = {f.name: _host(getattr(counters, f.name))
                      for f in dataclasses.fields(counters)}
                msgs = self._memory_message_count(mc)
                mdelta = msgs - self._prev_mem_msgs
                self._prev_mem_msgs = msgs
                f = self._file("network_utilization_memory")
                if f.tell() == 0:
                    f.write("# approximated from protocol counters "
                            "(see _memory_message_count)\n")
                f.write(f"{time_ns} {mdelta / interval_ns / T:.6f}\n")
        self._prev_sample_ns = time_ns
        if self.progress_enabled:
            self._progress_row(time_ns)

    # -- sampled run (`statistics_thread` + barrier wakeups) -------------
    def run(self, max_samples: int = 100000):
        """Run the simulation to completion, sampling every interval.
        Needs lax_barrier (as the reference does: `carbon_sim.cfg:397`);
        samples land on quantum boundaries."""
        sim = self.sim
        if sim.quantum_ps is None:
            raise ValueError(
                "statistics sampling needs clock_skew_management/scheme = "
                "lax_barrier (reference requirement)")
        quanta_per_sample = chunk_quanta(self.sampling_interval_ns,
                                         sim.quantum_ps)
        total_quanta = 0
        done = False
        for _ in range(max_samples):
            done, nq = sim.run_chunk(int(quanta_per_sample))
            total_quanta += nq
            # the loop skips empty quanta, so the time is the clocks'
            self.sample(time_ns=self._sim_time_ns())
            if done:
                break
        self.close()
        if not done:
            raise RuntimeError(
                f"statistics run truncated: {max_samples} samples "
                f"({total_quanta} quanta) without completing")
        return sim.results(total_quanta)
