"""Carry state between the JAX package's pytrees and the port's tensors.

The two packages share one layout (dicts and lists of arrays), so the
conversion is a tree map plus dtype and device handling:

* ``to_torch(tree, device)``: numpy-convertible leaves (numpy or JAX
  arrays, numpy scalars) -> tensors on ``device``.  uint32 leaves (the
  CCE ``hs`` hash coefficients) become int64, since torch has no usable
  uint32 arithmetic; bfloat16 crosses bit for bit.
* ``to_numpy(tree)``: tensors -> numpy arrays; the int64 ``hs`` leaves
  go back to uint32, bfloat16 to ``ml_dtypes.bfloat16``.

Tuples and lists keep their type; other leaves (python ints, strings,
None) pass through unchanged: the hash coefficients of the hashing trick,
CE, hash embeddings and ROBE stay python-int pairs (``"h"``, and ``"hs"``
tuples, which share CCE's key but are no arrays), and DHE's int32 ``a``/``b``
arrays (``a`` negative where numpy's int32 wrapped) stay int32.  ``train_state_to_torch`` carries a JAX
``TrainState`` across whole: params, the optimizer state (its moments
mirror params), the embedding buffers and the error feedback.
``lm_to_torch`` carries the JAX LM's ``(params, buffers)``: the stacked
``(L, ...)`` block leaves as they are, the CCE ``ptr``/``hs``/``epoch``
buffers, a ``FullTable`` head, the vlm family's ``patch_proj``, and a
tied configuration's layout, which has no ``head`` leaf at all.

``HostCopy(tree)`` starts the host copy of a tree of tensors without a
synchronisation, for the metrics pump and the sketch fold: each CUDA leaf
copies into pinned memory with ``non_blocking=True`` and one CUDA event is
recorded after the copies; ``get()`` waits on that event only.
"""
from __future__ import annotations

import numpy as np
import torch

#: Dict keys whose leaves are uint32 in the JAX package.
UINT32_KEYS = frozenset({"hs"})


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor, uint32: bool) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    a = t.numpy()
    return a.astype(np.uint32) if uint32 else a


def _is_leaf(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cuda"):
    """JAX-package pytree (numpy or JAX arrays) -> the port's tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if _is_leaf(tree):
        return _leaf_to_torch(tree, device)
    return tree


def to_numpy(tree, *, _uint32: bool = False):
    """The port's tensors -> numpy arrays in the JAX package's dtypes."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(v, _uint32=_uint32) for v in tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v, _uint32=k in UINT32_KEYS) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v, _uint32=_uint32) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _leaf_to_numpy(tree, _uint32)
    return tree


def train_state_to_torch(state, device="cuda"):
    """The JAX package's ``train.loop.TrainState`` -> the port's, with
    every array a tensor on ``device`` and the step a python int."""
    from repro_torch.train.loop import TrainState

    return TrainState(
        params=to_torch(state.params, device),
        opt=to_torch(state.opt, device),
        ebuf=to_torch(state.ebuf, device),
        step=int(np.asarray(state.step)),
        err=to_torch(state.err, device),
    )


def lm_to_torch(params, buffers, device="cuda"):
    """The JAX package's ``lm.init`` output (numpy or JAX arrays) -> the
    port's ``(params, buffers)`` for ``repro_torch.models.lm``: the two
    packages share the layout (``patch_proj`` and a tied config's missing
    ``head`` included), so this is a leaf-wise conversion."""
    return to_torch(params, device), to_torch(buffers, device)


class HostCopy:
    """The host copy of a tree (dicts, lists, tuples; tensor, numpy or
    python leaves), started at construction and read by ``get()``.

    CUDA leaves copy into pinned host tensors with ``non_blocking=True``
    and one event is recorded on the current stream after them, so
    neither the constructor nor ``get()`` waits for work enqueued later
    (a blocking ``.cpu()`` waits for everything enqueued so far).  CPU
    tensors are held as they are: a CPU op has finished when it
    returns.  ``get()`` returns the tree with numpy leaves."""

    def __init__(self, tree):
        self._event = None
        self._tree = self._start(tree)
        if self._event is not None:
            self._event.record()  # after every copy of the tree

    def _start(self, x):
        if isinstance(x, dict):
            return {k: self._start(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._start(v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type == "cpu":
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        if self._event is None:
            self._event = torch.cuda.Event()
        return host

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return self._numpy(self._tree)

    def _numpy(self, x):
        if isinstance(x, dict):
            return {k: self._numpy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._numpy(v) for v in x)
        return x.numpy() if isinstance(x, torch.Tensor) else x
