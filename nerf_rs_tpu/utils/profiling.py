"""Tracing / profiling utilities.

The reference's only instrumentation is one wall-clock Instant around the
whole render plus a println progress counter (/root/reference/src/lib.rs:
668-675,461-469). The replacements here:

- ``Phases`` — named wall-clock phase timers that wait for the device
  (``jax.block_until_ready``) before a phase closes.
- ``device_trace`` — a context manager around ``jax.profiler`` producing an
  XPlane/Perfetto trace dir for off-line analysis (xprof/tensorboard).
- ``Progress`` — rate-limited rays/s progress logging, the analogue of the
  reference's every-5000-pixels atomic counter print.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional



class Phases:
    """Accumulating named wall-clock timers.

    >>> ph = Phases()
    >>> with ph("coarse"):
    ...     out = coarse_step()
    ...     ph.sync(out)                 # force device completion
    >>> ph.report()
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def sync(value) -> None:
        """Block until ``value`` is computed on the device."""
        import jax

        jax.block_until_ready(value)

    def report(self, printer=print) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            printer(
                f"  {name:24s} {t * 1e3:9.1f} ms  ({100 * t / total:5.1f}%)"
                f"  x{self.counts[name]}"
            )
        return dict(self.totals)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace when ``log_dir`` is set; no-op otherwise (and a
    no-op with a warning when the profiler cannot start)."""
    if not log_dir:
        yield
        return
    import jax

    # Only guard trace *startup*: if the profiler cannot start, fall back
    # to a bare yield. Exceptions raised by the
    # traced body must propagate — never yield from an except branch, or
    # contextlib will throw the body's exception into the generator and a
    # second yield turns it into a masking RuntimeError.
    trace_cm = jax.profiler.trace(log_dir)
    try:
        trace_cm.__enter__()
    except Exception as e:
        print(f"profiler trace unavailable ({e}); continuing without")
        yield
        return
    try:
        yield
    finally:
        try:
            trace_cm.__exit__(None, None, None)
            print(f"profiler trace written to {log_dir}")
        except Exception as e:
            print(f"profiler trace finalize failed ({e}); continuing")


class Progress:
    """Rate-limited progress printer (reference: every-5000-pixels println,
    lib.rs:461-469 — here every ``interval`` seconds, with rays/s)."""

    def __init__(self, total_rays: int, interval: float = 2.0) -> None:
        self.total = total_rays
        self.interval = interval
        self.done = 0
        self._start = time.perf_counter()
        self._last = self._start

    def update(self, n_rays: int, printer=print) -> None:
        self.done += n_rays
        now = time.perf_counter()
        if now - self._last >= self.interval or self.done >= self.total:
            rate = self.done / max(now - self._start, 1e-9)
            printer(
                f"  {self.done}/{self.total} rays ({100 * self.done / self.total:.0f}%), "
                f"{rate:,.0f} rays/s"
            )
            self._last = now
