"""Named-section wall-clock profiler + phase-timing helpers (torch).

Counterpart of aniso_tpu/utils/profiler.py: `Profiler` tic/toc with counted
[C] / uncounted [U] tags and a percent-of-total table (reference
utility/Profiler.h:12-69), and the `RUN` phase macro (reference
bbfmm/utils.h:51-62).

Where JAX blocks on a result (`jax.block_until_ready`), these synchronize
the CUDA device once CUDA is in use, so a section measures execution, not
the enqueue; `trace()` wraps `torch.profiler` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """tic/toc named sections; summary printed via report() or on __exit__.

    Reference semantics: tic while clocking is a no-op (Profiler.h:32-33),
    toc(count=False) records the section time but excludes it from the
    counted total and tags it [U] (Profiler.h:47-56).
    """

    def __init__(self, sync: bool = True):
        self._times: Dict[str, float] = {}
        self._counted: Dict[str, bool] = {}
        self._order: list[str] = []
        self._total = 0.0
        self._clocking = False
        self._task: Optional[str] = None
        self._begin = 0.0
        self._sync = sync

    def tic(self, name: str = "") -> None:
        if self._clocking:
            return
        self._clocking = True
        self._task = name
        if name not in self._times:
            self._times[name] = 0.0
            self._order.append(name)
        self._counted[name] = False
        self._begin = time.perf_counter()

    def toc(self, count: bool = True, result: Any = None) -> Any:
        """End the current section, after the device has finished its work
        (with sync=True); returns `result`."""
        if not self._clocking:
            return result
        if self._sync:
            _sync()
        elapsed = time.perf_counter() - self._begin
        self._clocking = False
        self._times[self._task] += elapsed
        if count:
            self._total += elapsed
            self._counted[self._task] = True
        return result

    @contextlib.contextmanager
    def section(self, name: str, count: bool = True):
        """`with profiler.section("up pass"): ...` sugar over tic/toc."""
        self.tic(name)
        try:
            yield self
        finally:
            self.toc(count=count)

    def times(self) -> Dict[str, float]:
        return dict(self._times)

    @property
    def total(self) -> float:
        return self._total

    def report(self) -> str:
        """The reference's destructor table (Profiler.h:21-29)."""
        lines = []
        total = self._total if self._total > 0 else float("inf")
        for name in self._order:
            secs = self._times[name]
            tag = "[C]" if self._counted.get(name) else "[U]"
            lines.append(
                f"{name:>30s}{tag}{secs / total * 100:15.3f}%{secs:15.3f} seconds"
            )
        lines.append(f'{"counted time":>30s}{self._total:34.3f} seconds')
        return "\n".join(lines)

    def __enter__(self) -> "Profiler":
        return self

    def __exit__(self, *exc) -> None:
        print(self.report())


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace (CPU, and the card when CUDA is available)
    around a block of work, written to `logdir` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def timed(fn, *args, reps: int = 1, warmup: int = 1, **kwargs):
    """Median wall-clock of `fn(*args)` with device sync: the `RUN` macro
    analogue (utils.h:51-62), measuring steady state, not the first call."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2], samples
