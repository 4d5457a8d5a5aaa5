"""Simulated-time conversions: integer picoseconds, integer-MHz clocks.

Reference semantics: `common/misc/time_types.h:7-119`, as the JAX package
implements them (`graphite_tpu/time_types.py`): a latency of `cycles` at
`freq_mhz` is ceil(1e6 * cycles / freq_mhz) picoseconds, computed as an
exact integer ceil-division.  Each function takes Python ints (host math)
or int64 tensors (device math); the tensor forms truncate like the JAX
package's `lax.div`.
"""

from __future__ import annotations

from graphite_tpu_torch.intmath import nn_ceil_div

PS_PER_NS = 1000
PS_PER_CYCLE_NUMERATOR = 1_000_000  # ps/cycle = 1e6 / freq_mhz


def ghz_to_mhz(freq_ghz: float) -> int:
    """Represent a GHz float frequency exactly as integer MHz."""
    mhz = round(freq_ghz * 1000.0)
    if mhz <= 0:
        raise ValueError(f"non-positive frequency: {freq_ghz} GHz")
    return int(mhz)


def cycles_to_ps(cycles, freq_mhz):
    """Latency::toPicosec (`time_types.h:81-86`): ceil(1e6*cycles/freq_mhz)."""
    return nn_ceil_div(cycles * PS_PER_CYCLE_NUMERATOR, freq_mhz)


def ps_to_ns(ps):
    """Time::toNanosec (`time_types.h:111-114`): ceil(ps/1000)."""
    return nn_ceil_div(ps, PS_PER_NS)


def ns_to_ps(ns):
    return ns * PS_PER_NS


def ps_to_cycles(ps, freq_mhz):
    """Time::toCycles (`time_types.h:104-109`): ceil(ps*freq_mhz/1e6)."""
    return nn_ceil_div(ps * freq_mhz, PS_PER_CYCLE_NUMERATOR)
