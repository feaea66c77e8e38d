"""Trace spans and the opt-in profiler window (the port of the JAX
package's ``obs/trace.py``).

``span(name)`` stacks ``torch.profiler.record_function`` (the interval
shows in a captured profiler trace) with an NVTX range when CUDA is
available (the interval shows in an Nsight timeline).  Both are metadata:
no device work.  The phases the training loop annotates:

    dispatch     the train step call
    sketch-fold  tracker observe / async fold enqueue
    transition   the clustering transition (Alg. 3)
    checkpoint   async checkpoint save enqueue

``ProfileWindow`` captures a ``torch.profiler`` trace over a half-open
step window [start, stop) and writes it as a Chrome trace
(``<log_dir>/trace.json``).  One window per run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def span(name: str):
    """Annotate a logical phase in the profiler and, on CUDA, in NVTX."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@dataclasses.dataclass
class ProfileWindow:
    """Opt-in [start, stop) profiler capture, driven by step number."""

    start: int
    stop: int
    log_dir: str
    active: bool = False
    done: bool = False
    _prof: object = None

    def __post_init__(self):
        if not self.start < self.stop:
            raise ValueError(f"profile window [{self.start}, {self.stop}) is empty")

    @property
    def path(self) -> str:
        return os.path.join(self.log_dir, "trace.json")

    def observe(self, step: int) -> None:
        """Call once per loop iteration with the step about to run."""
        if self.active and step >= self.stop:
            self._stop()
        if not self.done and not self.active and self.start <= step < self.stop:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self.active = True

    def _stop(self) -> None:
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.active = False
        self.done = True

    def close(self) -> None:
        """Stop a still-open capture (end of run / exception path)."""
        if self.active:
            self._stop()
