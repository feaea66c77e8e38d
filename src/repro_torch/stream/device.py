"""In-step batch sketch updates and the asynchronous host fold: the port
of the JAX package's ``stream/device.py``.

  * ``cell_count_fn`` builds ONE function for all tracked features: hash
    every id of the (B, F_tracked) sparse block with each feature's
    multiply-shift coefficients (the SAME coefficients the host sketch
    uses, so device cells == host cells bit for bit) and count the hits
    into an (F_tracked, depth, width) int32 increment tensor.  uint32
    wraparound is emulated in int64 with ``& 0xFFFFFFFF`` and
    ``core.hashing._mul32`` (a product of two 32-bit values overflows
    int64).  The count is ``index_add_`` of ones into a zero int32
    vector: integer adds are exact in any order, so it is deterministic,
    and unlike ``bincount`` it reads nothing back to the host.
    ``make_step_cell_counter`` gives the ``sketch_fn`` that the train
    step calls on each microbatch (``make_train_step(sketch_fn=)``);
    ``make_cell_counter`` is the standalone counter for trackers running
    outside a train step.
  * ``AsyncFolder`` drains (host copy of the delta, host ids) pairs on a
    single background thread, FIFO: the wait for the delta's copy and the
    O(unique-ids) head/ring bookkeeping block the FOLD thread, never the
    step.  ``flush()`` is the barrier the tracker takes before sampling,
    statistics, or checkpointing, so flushed state is a pure function of
    the observed batch sequence and restart-exact resume holds with the
    async path on.
"""
from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.core.hashing import _MASK32, _mul32


def cell_count_fn(sketches):
    """(B, F) integer tensor -> (F, depth, width) int32 cell-increment
    counter over ``sketches`` (the tracked features' ``CountMinSketch``
    objects, which must share width/depth).  Runs on the input's device;
    the hash coefficients are copied there once per device."""
    widths = {s.width for s in sketches}
    depths = {s.depth for s in sketches}
    if len(widths) != 1 or len(depths) != 1:
        raise ValueError("tracked sketches must share width/depth")
    (width,), (depth,) = widths, depths
    n_feat = len(sketches)
    a_np = np.stack([s.a for s in sketches]).astype(np.int64)  # (F, depth)
    b_np = np.stack([s.b for s in sketches]).astype(np.int64)
    shift = int(sketches[0].shift)
    consts: dict[torch.device, tuple] = {}

    def count_cells(sparse: torch.Tensor) -> torch.Tensor:
        dev = sparse.device
        if dev not in consts:
            consts[dev] = (torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev),
                           torch.arange(n_feat * depth, device=dev)[:, None] * width)
        a, b, base = consts[dev]
        x = sparse.t().to(torch.int64) & _MASK32  # (F, B), as numpy's astype(uint32)
        cells = ((_mul32(x[:, None, :], a[:, :, None]) + b[:, :, None]) & _MASK32) >> shift
        # one flat count across every (feature, row) plane
        flat = (cells.reshape(n_feat * depth, -1) + base).reshape(-1)
        delta = torch.zeros(n_feat * depth * width, dtype=torch.int32, device=dev)
        delta.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.int32, device=dev))
        return delta.view(n_feat, depth, width)

    return count_cells


def make_cell_counter(sketches, device="cuda"):
    """Standalone counter around ``cell_count_fn``: host (B, F) ids ->
    (F, depth, width) int32 cells on ``device`` (one extra transfer and
    launch a batch; the train step's counter needs neither)."""
    fn = cell_count_fn(sketches)

    def count(cols) -> torch.Tensor:
        return fn(torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(device))

    return count


def make_step_cell_counter(tracker):
    """The ``sketch_fn`` a ``SketchFrequencyTracker`` contributes to
    ``train.loop.make_train_step``: microbatch dict -> (F_tracked, depth,
    width) int32 cell delta, computed on the microbatch's device from its
    tracked sparse columns with the host sketches' coefficients.  Returns
    None when the tracker has no sketch-backed features (dense tracker,
    or nothing tracked)."""
    tracked = getattr(tracker, "tracked", None)
    if not tracked:
        return None
    fn = cell_count_fn([tracker.features[f].cms for f in tracked])
    cols = torch.tensor(tracked, dtype=torch.int64)
    on: dict[torch.device, torch.Tensor] = {}
    key = tracker.key

    def count(microbatch) -> torch.Tensor:
        sparse = microbatch[key]
        if sparse.device not in on:
            on[sparse.device] = cols.to(sparse.device)
        return fn(sparse.index_select(1, on[sparse.device]))

    return count


class AsyncFolder:
    """FIFO background folder with error propagation on the barrier.
    ``fold_ms`` holds the wall time of the last ``maxlen_ms`` folds (on the
    fold thread: the wait for the delta's copy and the host bookkeeping)."""

    def __init__(self, fold_fn, maxsize: int = 64, maxlen_ms: int = 10_000):
        self._fold = fold_fn
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._error: BaseException | None = None
        self.fold_ms: collections.deque[float] = collections.deque(maxlen=maxlen_ms)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if self._error is None:  # after an error, drain without work
                    t0 = time.perf_counter()
                    self._fold(item)
                    self.fold_ms.append((time.perf_counter() - t0) * 1e3)
            except BaseException as e:  # surfaced on the next flush()
                self._error = e
            finally:
                self._q.task_done()

    def submit(self, item) -> None:
        if self._error is not None:
            self.flush()  # raises
        self._q.put(item)  # bounded: backpressure instead of unbounded lag

    def flush(self) -> None:
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
