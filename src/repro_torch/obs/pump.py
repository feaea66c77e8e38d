"""The metrics pump — host-side metric draining that never stalls the
stream (the port of the JAX package's ``obs/pump.py``).

CUDA work is asynchronous: the step returns tensors whose values the
device has yet to compute.  Reading one (``float(metrics["loss"])``, a
blocking ``.cpu()``) waits for everything enqueued so far, later steps
included.  ``push`` instead starts each step's host copy at once
(``convert.HostCopy``: pinned buffers, ``non_blocking=True``, one CUDA
event) and a record is read once it is ``lag`` steps behind the front,
waiting on that step's event only.

  * ``history`` — bounded deque (``maxlen``) of per-step records: python
    floats for 0-d values, numpy arrays for vectors.
  * ``sink``    — optional callback per drained record (the Trainer wires
    ``RunLog.log_step`` through it).

``flush()`` drains everything in flight: records are exact and complete
after a flush; only their timing is late.
"""
from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np

from repro_torch.convert import HostCopy


def _record_leaves(tree):
    if isinstance(tree, dict):
        return {k: _record_leaves(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return float(arr) if arr.ndim == 0 else arr


class MetricsPump:
    """Ring of (step, host copy in flight) drained ``lag`` steps late."""

    def __init__(self, *, lag: int = 8, maxlen: int | None = 10_000,
                 sink: Callable[[dict], None] | None = None):
        self.lag = max(0, int(lag))
        self.history: deque[dict] = deque(maxlen=maxlen)
        self.sink = sink
        self._ring: deque = deque()

    def __len__(self) -> int:  # records still in flight
        return len(self._ring)

    def push(self, step: int, metrics, *, extra: dict | None = None) -> None:
        """Start one step's host copy; drain whatever fell ``lag`` steps
        behind.  ``extra`` carries host-side fields (dt)."""
        self._ring.append((step, HostCopy(metrics), extra))
        while len(self._ring) > self.lag:
            self._drain_one()

    def _drain_one(self) -> None:
        step, host, extra = self._ring.popleft()
        record = _record_leaves(host.get())
        record["step"] = int(step)
        if extra:
            record.update(extra)
        self.history.append(record)
        if self.sink is not None:
            self.sink(record)

    def flush(self) -> None:
        """Drain every in-flight record."""
        while self._ring:
            self._drain_one()
