"""Pass timings and the frame meter.

The counterpart of the JAX package's ``utils/profiler.py``, the headless
form of the reference's two instruments (SURVEY.md §5):

* ``PassProfiler`` (profiler.ts:45-140): named timings of the passes on the
  host clock, as rolling statistics. A section waits for the device only
  when it is given ``sync=``: then its time is the device's wall clock;
  without it, the time it took to queue the pass's work.
* ``FrameMeter`` (fps-meter.tsx:3-141): a rolling window (100 samples, as
  the reference's) of frame times with fps, mean, min and max.
* ``trace_annotation``: a named range in ``torch.profiler`` captures
  (``torch.profiler.record_function``, where the JAX package bridges to
  its own profiler).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


def _synchronize(values) -> None:
    """Wait for the devices that hold ``values`` (a tensor or a sequence of
    them); CPU tensors need no wait."""
    if isinstance(values, torch.Tensor):
        values = (values,)
    for dev in {v.device for v in values if isinstance(v, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class PassProfiler:
    def __init__(self, window: int = 100):
        self.window = window
        self._samples: dict[str, collections.deque] = {}

    @contextlib.contextmanager
    def section(self, label: str, sync=None):
        """Time a named pass. ``sync``: tensor(s) the pass produces; the
        section waits for their device before it stops the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.add(label, time.perf_counter() - t0)

    def add(self, label: str, seconds: float) -> None:
        self._samples.setdefault(
            label, collections.deque(maxlen=self.window)).append(seconds)

    def stats(self) -> dict:
        """Per label {last, avg, min, max} in milliseconds and the count
        (profiler.ts:138, getStats)."""
        out = {}
        for label, q in self._samples.items():
            ms = [s * 1e3 for s in q]
            out[label] = {"last_ms": ms[-1], "avg_ms": sum(ms) / len(ms),
                          "min_ms": min(ms), "max_ms": max(ms),
                          "count": len(ms)}
        return out


class FrameMeter:
    """Rolling frame-time meter (fps-meter.tsx: a 100-sample window)."""

    def __init__(self, window: int = 100):
        self._times = collections.deque(maxlen=window)
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def stats(self) -> dict:
        if not self._times:
            return {"fps": 0.0, "frame_ms": 0.0, "min_ms": 0.0, "max_ms": 0.0}
        avg = sum(self._times) / len(self._times)
        return {"fps": 1.0 / avg if avg > 0 else 0.0, "frame_ms": avg * 1e3,
                "min_ms": min(self._times) * 1e3,
                "max_ms": max(self._times) * 1e3}


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in ``torch.profiler`` captures."""
    with torch.profiler.record_function(name):
        yield


def mrays_per_sec(ray_count: int, seconds: float) -> float:
    return ray_count / max(seconds, 1e-12) / 1e6
