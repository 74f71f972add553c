"""Observability: named wall-clock timers and scalar stats.

API-compatible re-design of the reference's StatsTracker
(/root/reference/src/flame/utils/stats_tracker.h:38-164): tick/tock named
timers in milliseconds, set/add scalar stats, and key prefixing. Thread-safe
via a single lock, like the reference. Adds: EMA timings, structured
snapshot export, and optional jax.profiler trace annotation around
tick/tock pairs (the analogue of per-stage printf timing,
reference params.h:113-132).
"""

import threading
import time
from contextlib import contextmanager
from typing import Dict

try:  # Optional: annotate traces when profiling is active.
    import jax.profiler as _jax_profiler
except Exception:  # pragma: no cover
    _jax_profiler = None


class StatsTracker:
    """Named timers (milliseconds) and scalar statistics."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._lock = threading.Lock()
        self._tick_times: Dict[str, float] = {}
        self._timings: Dict[str, float] = {}
        self._stats: Dict[str, float] = {}

    def _key(self, name: str) -> str:
        return self._prefix + name

    # --- Timers. ---

    def tick(self, name: str) -> None:
        with self._lock:
            self._tick_times[self._key(name)] = time.perf_counter()

    def tock(self, name: str) -> float:
        """Stop timer; returns and records elapsed milliseconds."""
        now = time.perf_counter()
        key = self._key(name)
        with self._lock:
            start = self._tick_times.get(key)
            if start is None:
                return 0.0
            ms = (now - start) * 1000.0
            self._timings[key] = ms
            return ms

    def timings(self, name: str) -> float:
        with self._lock:
            return self._timings.get(self._key(name), 0.0)

    @contextmanager
    def timed(self, name: str):
        """Context-manager form of tick/tock, with profiler annotation."""
        if _jax_profiler is not None:
            ctx = _jax_profiler.TraceAnnotation(self._key(name))
        else:  # pragma: no cover
            ctx = _nullcontext()
        self.tick(name)
        try:
            with ctx:
                yield
        finally:
            # tock even when the body raises: a leaked tick would pin
            # this stage's reported duration at its previous value.
            self.tock(name)

    # --- Scalar stats. ---

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._stats[self._key(name)] = float(value)

    def add(self, name: str, value: float) -> None:
        with self._lock:
            key = self._key(name)
            self._stats[key] = self._stats.get(key, 0.0) + float(value)

    def stats(self, name: str) -> float:
        with self._lock:
            return self._stats.get(self._key(name), 0.0)

    def ema(self, name: str, value: float, alpha: float = 0.01) -> float:
        """Update an exponential moving average stat, returning the new value
        (the reference's fps/fps_max EMA pattern, flame.cc:513-539)."""
        with self._lock:
            key = self._key(name)
            old = self._stats.get(key)
            new = float(value) if old is None else (1 - alpha) * old + alpha * float(value)
            self._stats[key] = new
            return new

    # --- Export. ---

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"timings_ms": dict(self._timings), "stats": dict(self._stats)}

    def clear(self) -> None:
        with self._lock:
            self._tick_times.clear()
            self._timings.clear()
            self._stats.clear()


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
