"""Observability: phase timing and bandwidth accounting.

The reference reports only whole-sort wall clock (main.rs:32-44). Here every
measurement ends in ``jax.block_until_ready`` and is reported against the
device's published memory bandwidth (:data:`PEAK_HBM_BYTES_PER_S`, keyed by
``jax.Device.device_kind``) so regressions are attributable.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax

__all__ = [
    "PhaseTimer", "speed_of_light_s", "peak_hbm_bytes_per_s",
    "PEAK_HBM_BYTES_PER_S",
]

# Published peak device-memory bandwidth, bytes/s, by device_kind.
# NVIDIA H100 Tensor Core GPU data sheet: H100 SXM5, 80 GB HBM3, 3.35 TB/s.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    """Published peak memory bandwidth of ``device_kind``; a device that is
    not in :data:`PEAK_HBM_BYTES_PER_S` is an error, never a default."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known kinds: {sorted(PEAK_HBM_BYTES_PER_S)}"
        ) from None


def speed_of_light_s(bytes_moved: int, device_kind: str) -> float:
    """Lower bound on wall-clock for moving ``bytes_moved`` through the
    memory of a ``device_kind`` device."""
    return bytes_moved / peak_hbm_bytes_per_s(device_kind)


@dataclass
class PhaseTimer:
    """Accumulates named phase timings with bandwidth annotations.

    with timer.phase("extract", bytes_moved=n * 16):
        out = jax.block_until_ready(fn(*args))
    print(timer.report(jax.devices()[0].device_kind))
    """

    phases: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.phases.append((name, dt, bytes_moved))

    def time_fn(self, name: str, fn, *args, bytes_moved: int = 0):
        """Run ``fn`` once to completion, recording the phase."""
        with self.phase(name, bytes_moved=bytes_moved):
            out = jax.block_until_ready(fn(*args))
        return out

    def report(self, device_kind: str) -> str:
        peak = peak_hbm_bytes_per_s(device_kind)
        total = sum(dt for _, dt, _ in self.phases)
        lines = [f"{'phase':<20} {'ms':>9} {'share':>7} {'GB/s':>8} "
                 f"{'vs SoL':>7}"]
        for name, dt, nbytes in self.phases:
            rate = nbytes / dt if nbytes else 0.0
            sol = f"{rate / peak:6.1%}" if nbytes else "      -"
            gb = f"{rate / 1e9:8.1f}" if nbytes else "       -"
            lines.append(
                f"{name:<20} {dt*1e3:9.2f} {dt/total:6.1%} {gb} {sol}")
        lines.append(f"{'total':<20} {total*1e3:9.2f}")
        return "\n".join(lines)

    def trace(self, path: str):
        """Context manager: capture a jax.profiler trace (when the backend
        supports it) for offline inspection."""
        return jax.profiler.trace(path)
