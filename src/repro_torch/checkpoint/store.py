"""Atomic, async, resume-exact checkpoints: the port of the JAX package's
``checkpoint/store.py``, in its format, so that each package reads the
other's checkpoints.

Layout: one directory per step,
    <dir>/step_000123/
        manifest.json        — step, leaf count, shapes, dtypes, sections
        arr_<idx>.npy        — one file per leaf
        _COMMITTED           — written last; partial checkpoints are ignored

Leaves are numbered in ``jax.tree`` order (``tree.jax_leaves``: dicts by
sorted key), and stored in the JAX package's dtypes (``convert.to_numpy``:
the int64 ``hs`` buffers as uint32, bfloat16 as ``ml_dtypes.bfloat16``).
A python int leaf (the port's ``TrainState.step``) is stored as the
callers pass it: the Trainer passes ``np.int32``, the JAX step's dtype.
A restore rebuilds the template's structure and gives each leaf the
template leaf's type: a tensor of its dtype on its device, a python int,
or a numpy array as stored.  The python-int hash coefficients of the
non-transitioning tables are static in the JAX package's train state and
no leaves of its checkpoints: a caller stores its buffers through
``tree.drop_static`` (None there) and restores with ``tree.fill_static``,
as the Trainer does.

  * atomicity — the _COMMITTED marker is written after all data + fsync,
    so a job killed mid-save restarts from the previous step.
  * async — ``CheckpointManager.save_async`` copies the tree to host
    memory (the one synchronisation) and writes on a background thread.
  * retention — keep_last N checkpoints, garbage-collected after commit.
  * sections — a top-level dict tree records its per-key leaf counts
    (``toplevel``), so a reader with other optional host-state sections
    (``id_counts``, ``trigger``) aligns them by name.

A model-sharded trainer stores the whole layout too: its shards are
gathered to rank 0, which writes (``train.loop.Trainer``), and
``reshard_restore`` cuts each rank's slice out of a restored whole tree,
so a checkpoint moves between 1-device and sharded trainers, and between
shard counts (through ``dlrm.checkpoint_migrations`` where ``k_multiple``
differs).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import convert
from repro_torch.tree import jax_leaves, jax_unflatten, tree_map

Pytree = Any

_COMMIT = "_COMMITTED"


def to_host(tree: Pytree) -> Pytree:
    """A copy of the tree with numpy leaves in the JAX package's dtypes
    (python scalars as they are): nothing in it shares memory with a
    tensor of ``tree``, which the train step updates in place."""
    return convert.to_numpy(tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) and x.device.type == "cpu" else x,
        tree))


def save_checkpoint(directory: str, step: int, tree: Pytree, *, extra: dict | None = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = jax_leaves(to_host(tree))
    manifest = {
        "step": step,
        "treedef": f"repro_torch {type(tree).__name__}",  # informational
        "n_leaves": len(flat),
        "extra": extra or {},
        "leaves": [],
    }
    if isinstance(tree, dict):
        # top-level section index: per-key leaf counts, in sorted key order
        manifest["toplevel"] = [[k, len(jax_leaves(tree[k]))] for k in sorted(tree)]
    for i, leaf in enumerate(flat):
        arr = np.asarray(leaf)
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    with open(os.path.join(path, _COMMIT), "w") as f:
        f.write(str(time.time()))
        f.flush()
        os.fsync(f.fileno())
    return path


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    """Committed checkpoints, ascending by step."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        p = os.path.join(directory, name)
        if name.startswith("step_") and os.path.exists(os.path.join(p, _COMMIT)):
            out.append((int(name.split("_")[1]), p))
    return sorted(out)


def _size(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else int(np.size(t))


def _shapes_match(t_leaves, stored) -> bool:
    """Template-vs-stored leaf compatibility: equal count, equal shapes —
    except zero-size template leaves, which are wildcards (they absorb a
    stored leaf of any shape)."""
    return len(t_leaves) == len(stored) and not any(
        hasattr(t, "shape") and _size(t) > 0 and tuple(t.shape) != tuple(leaf.shape)
        for t, leaf in zip(t_leaves, stored)
    )


def _like(tmpl, arr: np.ndarray):
    """A stored array in the template leaf's type: a tensor of its dtype
    on its device, a python scalar of its type, else the array."""
    if isinstance(tmpl, torch.Tensor):
        return convert._leaf_to_torch(arr, tmpl.device).to(tmpl.dtype)
    if isinstance(tmpl, (bool, int, float)):
        return type(tmpl)(arr)
    return arr


def _fill(tmpl: Pytree, leaves) -> Pytree:
    return jax_unflatten(tmpl, [_like(t, a) for t, a in zip(jax_leaves(tmpl), leaves)])


def _align_toplevel(tmpl: Pytree, leaves, toplevel, *, allow_drop: bool) -> Pytree | None:
    """Section-aware restore for top-level dict trees: align stored leaf
    runs to template keys by NAME.  With ``allow_drop``, stored sections
    the template lacks are dropped; template keys the store lacks keep the
    template's value (fresh state).  Returns None when any shared
    section's leaves don't fit the template, or (without ``allow_drop``)
    when a stored section goes unconsumed."""
    if not isinstance(tmpl, dict):
        return None
    stored: dict[str, list] = {}
    off = 0
    for k, n in toplevel:
        stored[k] = leaves[off: off + n]
        off += n
    if off != len(leaves):
        return None  # corrupt/foreign section index
    if not allow_drop and any(k not in tmpl for k in stored):
        return None
    out = {}
    for k, sub in tmpl.items():
        if k not in stored:
            out[k] = sub
            continue
        if not _shapes_match(jax_leaves(sub), stored[k]):
            return None
        out[k] = _fill(sub, stored[k])
    return out


def load_checkpoint(directory: str, *, step: int | None = None,
                    template: Pytree | None = None, migrations=()):
    """Load the latest (or given-step) committed checkpoint.

    Returns (step, tree, extra); the tree takes ``template``'s structure
    and leaf types.  ``migrations`` is an ordered sequence of
    ``(template, convert)`` layout candidates, tried after ``template``
    until one matches the stored leaves (count and every shape; a
    zero-size template leaf is a wildcard); its ``convert`` (None for
    identity) maps the restored tree to the current layout."""
    ckpts = list_checkpoints(directory)
    if not ckpts:
        raise FileNotFoundError(f"no committed checkpoints under {directory}")
    if step is None:
        step, path = ckpts[-1]
    else:
        match = [p for s, p in ckpts if s == step]
        if not match:
            raise FileNotFoundError(f"step {step} not found under {directory}")
        path = match[0]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = [np.load(os.path.join(path, f"arr_{i}.npy")) for i in range(manifest["n_leaves"])]
    candidates = ([(template, None)] if template is not None else []) + list(migrations)
    if not candidates:
        raise ValueError("pass template= to reconstruct the tree structure")
    toplevel = manifest.get("toplevel")
    err: Exception | None = None
    # two passes: exact whole-tree and drop-free section alignment first,
    # then alignments that DISCARD stored sections — so a candidate that
    # merely drops data never wins over a later one that migrates it
    for allow_drop in (False, True):
        for tmpl, conv in candidates:
            t_leaves = jax_leaves(tmpl)
            if not allow_drop and _shapes_match(t_leaves, leaves):
                tree = _fill(tmpl, leaves)
            elif toplevel is not None:
                tree = _align_toplevel(tmpl, leaves, toplevel, allow_drop=allow_drop)
                if tree is None:
                    err = err or ValueError("stored sections do not fit this layout template")
                    continue
            else:
                err = err or ValueError(
                    f"leaf count/shape mismatch: checkpoint has {len(leaves)} "
                    f"leaves, template has {len(t_leaves)}"
                )
                continue
            if conv is not None:
                tree = conv(tree)
            return manifest["step"], tree, manifest.get("extra", {})
    raise err  # no candidate layout matched


def reshard_restore(tree: Pytree, specs: Pytree, rank: int, n_shards: int, *,
                    device=None) -> Pytree:
    """Rank ``rank``'s shard of a restored whole ``tree`` under ``specs``
    (``launch.steps.dlrm_state_specs``; ``shard.shard_tree``), its tensors
    moved to ``device`` when given.  The saved and the restoring shard
    counts need not match."""
    from repro_torch.shard import shard_tree

    out = shard_tree(tree, specs, rank, n_shards)
    if device is None:
        return out
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, out)


class CheckpointManager:
    """Async save + retention.  One background writer thread; ``wait()``
    is the barrier (before exit and in tests).  ``enqueue_ms`` and
    ``write_ms`` hold each save's host copy and background write times."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.enqueue_ms: list[float] = []
        self.write_ms: list[float] = []
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Pytree, *, extra: dict | None = None):
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        # copy to host memory NOW: the step updates the state in place
        host_tree = to_host(tree)
        self.enqueue_ms.append((time.perf_counter() - t0) * 1e3)

        def work():
            t1 = time.perf_counter()
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e
            self.write_ms.append((time.perf_counter() - t1) * 1e3)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for _, path in list_checkpoints(self.directory)[: -self.keep_last]:
            shutil.rmtree(path, ignore_errors=True)

    def restore_latest(self, template: Pytree):
        self.wait()
        return load_checkpoint(self.directory, template=template)
