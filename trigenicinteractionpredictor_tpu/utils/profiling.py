"""Tracing / profiling helpers (SURVEY.md §6 "Tracing / profiling").

The reference's only instrumentation is wall-clock prints.  Here:

- :func:`trace` — context manager around any region that writes a
  perfetto-compatible ``jax.profiler`` trace (open in
  ui.perfetto.dev or TensorBoard's profile plugin);
- :func:`timed` — wall-clock timing of a jitted step, synced with
  ``block_until_ready``;
- :class:`SweepTimer` — running throughput stats the trainer logs into
  events.jsonl.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """jax.profiler trace around a region: ``with trace("runs/prof"): ...``"""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1):
    """Wall-clock a jitted callable: returns (seconds_per_call, last_output).

    Chains nothing between calls (same inputs each time); syncs once at the
    end.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


@dataclass
class SweepTimer:
    """Throughput accounting for the training loop."""

    n_triplets: int
    started: float = field(default_factory=time.perf_counter)
    sweeps: int = 0

    def tick(self, n: int = 1) -> None:
        self.sweeps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.started

    @property
    def triplets_per_sec(self) -> float:
        return self.sweeps * self.n_triplets / max(self.elapsed, 1e-9)
