"""Schema-versioned JSONL run log + the fixed-bucket latency histogram
(the JAX package's ``obs/runlog.py``, whose format this keeps, so one
summarizer reads the logs of both).

One line per record.  The first line of a fresh file is the MANIFEST
(``event: "manifest"``) carrying ``schema`` (``SCHEMA_VERSION``) and the
run's identifying facts.  Every other line is a typed event.  Adding
fields or event types keeps ``SCHEMA_VERSION``; renaming or re-typing a
field bumps it.  Re-opening an existing log APPENDS, and a replayed
(event, step) pair already in the file is dropped; events that recur at
one step legitimately opt out with ``dedupe=False``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

SCHEMA_VERSION = 1


def _json_default(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"not JSON-serializable: {type(x).__name__}")


class RunLog:
    """Append-only JSONL writer with (event, step) replay dedupe."""

    def __init__(self, path, *, manifest: dict | None = None):
        self.path = os.fspath(path)
        self._seen: set[tuple[str, int]] = set()
        self.manifest: dict | None = None
        existing = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        if existing:
            for rec in read_runlog(self.path):
                if rec.get("event") == "manifest":
                    self.manifest = rec
                elif "step" in rec:
                    self._seen.add((rec["event"], int(rec["step"])))
            self._f = open(self.path, "a")
            if self.manifest is not None and self.manifest.get("schema") != SCHEMA_VERSION:
                import warnings

                warnings.warn(
                    f"resuming run log with schema {self.manifest.get('schema')} "
                    f"!= {SCHEMA_VERSION}; appended records use the current schema"
                )
        else:
            self._f = open(self.path, "w")
            self.manifest = {
                "event": "manifest",
                "schema": SCHEMA_VERSION,
                "time": time.time(),
                **(manifest or {}),
            }
            self._write(self.manifest)

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, default=_json_default) + "\n")
        self._f.flush()

    def append(self, event: str, *, step: int | None = None, dedupe: bool = True,
               **fields) -> bool:
        """Write one event line.  Returns False when the (event, step)
        pair was already logged (a replayed event after resume)."""
        if step is not None:
            key = (event, int(step))
            if dedupe and key in self._seen:
                return False
            self._seen.add(key)
        rec = {"event": event}
        if step is not None:
            rec["step"] = int(step)
        rec.update(fields)
        self._write(rec)
        return True

    def log_step(self, record: dict) -> bool:
        """One step record -> one ``step`` event."""
        rec = dict(record)
        step = rec.pop("step")
        return self.append("step", step=step, **rec)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_runlog(path) -> list[dict]:
    """Parse a JSONL run log (tolerates a truncated final line)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


class LatencyHistogram:
    """Fixed log-spaced latency buckets (seconds): constant memory at any
    request volume, mergeable by adding counts.  ``n_buckets`` spans
    [lo, hi) geometrically; observations clamp into the end buckets.
    Percentiles are upper-edge estimates."""

    def __init__(self, lo: float = 1e-5, hi: float = 10.0, n_buckets: int = 40):
        if not (0 < lo < hi and n_buckets >= 2):
            raise ValueError(f"need 0 < lo < hi and n_buckets >= 2, got {lo}, {hi}, {n_buckets}")
        self.lo, self.hi = float(lo), float(hi)
        self.edges = np.geomspace(lo, hi, n_buckets - 1)
        self.counts = np.zeros(n_buckets, np.int64)

    @property
    def n(self) -> int:
        return int(self.counts.sum())

    def observe(self, seconds: float) -> None:
        self.counts[int(np.searchsorted(self.edges, seconds, "right"))] += 1

    def percentile(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` in [0, 100]."""
        if self.n == 0:
            return 0.0
        rank = np.ceil(self.n * q / 100.0)
        idx = int(np.searchsorted(np.cumsum(self.counts), max(rank, 1)))
        return float(self.edges[min(idx, len(self.edges) - 1)])

    def to_dict(self) -> dict:
        return {
            "lo": self.lo,
            "hi": self.hi,
            "edges": self.edges.tolist(),
            "counts": self.counts.tolist(),
            "n": self.n,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }
