"""Every training-time table-compression method of the paper's Section 2,
in its unified sketching framework  T = H @ M,  lookup(i) = (e_i H) M:
the uncompressed ``FullTable``, the hashing trick, hash embeddings,
compositional embeddings (CE, concat), ROBE, deep hash embeddings (DHE),
TT-Rec, and (in ``core/cce.py``) CCE.  Each is a frozen config with
functional state:

    table.init(generator, device)          -> (params, buffers)
    table.lookup(params, buffers, ids)     -> (..., d2) embeddings
    table.logits(params, buffers, h)       -> (..., d1) output head
    table.sketch_matrix(buffers)           -> dense H (d1, k), numpy (tests)

plus the ``FuseSpec`` protocol through which the collection fuses every
gather-sum table (full, hash, CE, CCE) into one supertable
(``core/collection.py``); the others take the per-feature loop.

Integer buffers equal the JAX package's bit for bit: hash coefficients
are python ints (``(a, b)`` pairs, static leaves of the JAX train state)
and DHE's are int32 arrays.  Float draws come from the generator and do
not reproduce JAX's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing


class FuseSpec(NamedTuple):
    """A table's natural shape inside the universal supertable: ``cols``
    columns of ``n_tables`` stacked (k, dsub) sub-tables, looked up as
    ``sum_t tab[t][rows[:, t]]`` per column."""

    cols: int
    n_tables: int
    k: int
    dsub: int


def _split_budget_rows(budget: int, d2: int, n_tables: int = 1) -> int:
    return max(1, budget // (d2 * n_tables))


def _randn(generator: torch.Generator, shape, scale: float, dtype, device):
    """Standard normal draws on the generator's device, scaled, then cast
    and moved."""
    x = torch.randn(shape, generator=generator, device=generator.device) * scale
    return x.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class FullTable:
    """The uncompressed baseline: one row per id."""

    d1: int
    d2: int
    dtype: Any = torch.float32

    @property
    def n_params(self) -> int:
        return self.d1 * self.d2

    def init_buffers(self):
        return {}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2)
        return {"table": _randn(generator, (self.d1, self.d2), scale, self.dtype, device)}, {}

    def lookup(self, params, buffers, ids):
        return params["table"][ids.clamp(0, self.d1 - 1)]

    def logits(self, params, buffers, h):
        """Output head over the whole vocabulary: ``h @ table.T`` (...,
        d1), in the dtype the two promote to (as jnp promotes)."""
        return promote_matmul(h, params["table"].T)

    def sketch_matrix(self, buffers) -> np.ndarray:
        return np.eye(self.d1, dtype=np.float32)

    # --- the padded gather of full-table groups -------------------------

    @staticmethod
    def stack_many(tables, params_seq):
        """Per-feature {"table": (d1_f, d2)} -> {"table": (F, max d1_f, d2)},
        zero-padding the row axis."""
        d1_pad = max(t.d1 for t in tables)
        return {
            "table": torch.stack(
                [
                    torch.nn.functional.pad(p["table"], (0, 0, 0, d1_pad - t.d1))
                    for t, p in zip(tables, params_seq)
                ]
            )
        }

    @staticmethod
    def unstack_many(tables, group_params):
        return [
            {"table": group_params["table"][f, : t.d1]}
            for f, t in enumerate(tables)
        ]

    @staticmethod
    def lookup_many(tables, group_params, buffers_seq, ids):
        """ONE padded gather for the group: ids (B, F) -> (B, F, d2), each
        id clamped to its own feature's vocab."""
        F = len(tables)
        caps = torch.tensor([t.d1 - 1 for t in tables], device=ids.device)
        ids = torch.minimum(ids.clamp(min=0), caps[None, :])
        return group_params["table"][torch.arange(F, device=ids.device)[None, :], ids]

    # --- universal fusion -----------------------------------------------

    @property
    def fuse_spec(self) -> FuseSpec:
        """One column whose codebook IS the table (identity rows)."""
        return FuseSpec(cols=1, n_tables=1, k=self.d1, dsub=self.d2)

    def group_signature(self):
        return ("full", self.d2, str(self.dtype))

    def fuse_slab(self, params):
        return params["table"][None, None]  # (1, 1, d1, d2)

    def unfuse_slab(self, slab):
        return {"table": slab[0, 0]}

    def fuse_rows(self, buffers, ids):
        return ids.clamp(0, self.d1 - 1).to(torch.int32)[None, :, None]

    def fuse_rows_np(self, buffers, ids):
        return np.clip(np.asarray(ids), 0, self.d1 - 1).astype(np.int32)[None, :, None]


def promote_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype the two promote to: jnp promotes a bf16 by
    f32 product to f32, while ``torch.matmul`` refuses mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _hash_rows(coeffs, ids: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    """Rows of every (a, b) multiply-shift pair in ``coeffs`` over ``ids``,
    stacked along ``dim``, int64 (ready to index with)."""
    return torch.stack(
        [hashing.multiply_shift(ids, int(a), int(b), m) for a, b in coeffs], dim=dim
    ).to(torch.int64)


def _one_hot_sketch(d1: int, k: int, cols) -> np.ndarray:
    """Dense (d1, k) H with a one added at (v, cols[j][v]) for every j."""
    H = np.zeros((d1, k), np.float32)
    for c in cols:
        H[np.arange(d1), c] += 1.0
    return H


@dataclasses.dataclass(frozen=True)
class HashingTrick:
    """Weinberger et al. 2009: one hash, k rows shared across the vocab."""

    d1: int
    d2: int
    k: int
    seed_salt: int = 0
    dtype: Any = torch.float32

    @classmethod
    def from_budget(cls, d1, d2, budget, **kw):
        return cls(d1, d2, k=min(d1, _split_budget_rows(budget, d2)), **kw)

    @property
    def n_params(self) -> int:
        return self.k * self.d2

    def init_buffers(self):
        """The hash coefficients as python ints, derived from ``seed_salt``."""
        h = hashing.make_hash(self.seed_salt * 7919 + 11, self.k)
        return {"h": (h.a, h.b)}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2)
        return {"M": _randn(generator, (self.k, self.d2), scale, self.dtype, device)}, \
            self.init_buffers()

    def _rows(self, buffers, ids):
        return _hash_rows([buffers["h"]], ids, self.k, -1)[..., 0]

    def lookup(self, params, buffers, ids):
        return params["M"][self._rows(buffers, ids)]

    def logits(self, params, buffers, h):
        scores = promote_matmul(h, params["M"].T)  # (..., k)
        return scores[..., self._rows(buffers, torch.arange(self.d1, device=h.device))]

    def sketch_matrix(self, buffers) -> np.ndarray:
        return _one_hot_sketch(self.d1, self.k, [self._rows(buffers, torch.arange(self.d1)).numpy()])

    # --- universal fusion -----------------------------------------------

    @property
    def fuse_spec(self) -> FuseSpec:
        """One hash, one table: a single column of k shared rows."""
        return FuseSpec(cols=1, n_tables=1, k=self.k, dsub=self.d2)

    def fuse_slab(self, params):
        return params["M"][None, None]  # (1, 1, k, d2)

    def unfuse_slab(self, slab):
        return {"M": slab[0, 0]}

    def fuse_rows(self, buffers, ids):
        return self._rows(buffers, ids).to(torch.int32)[None, :, None]  # (1, B, 1)

    def fuse_rows_np(self, buffers, ids):
        a, b = buffers["h"]
        return hashing.multiply_shift_np(np.asarray(ids), a, b, self.k)[None, :, None]


@dataclasses.dataclass(frozen=True)
class HashEmbedding:
    """Tito Svenstrup et al. 2017: the sum of ``n_hash`` rows (H has
    n_hash ones a row)."""

    d1: int
    d2: int
    k: int
    n_hash: int = 2
    seed_salt: int = 0
    dtype: Any = torch.float32

    @classmethod
    def from_budget(cls, d1, d2, budget, **kw):
        return cls(d1, d2, k=min(d1, _split_budget_rows(budget, d2)), **kw)

    @property
    def n_params(self) -> int:
        return self.k * self.d2

    def init_buffers(self):
        hs = hashing.make_hashes(self.seed_salt * 7919 + 22, self.n_hash, self.k)
        return {"hs": tuple((h.a, h.b) for h in hs)}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2 * self.n_hash)
        return {"M": _randn(generator, (self.k, self.d2), scale, self.dtype, device)}, \
            self.init_buffers()

    def _rows(self, buffers, ids):
        return _hash_rows(buffers["hs"], ids, self.k, -1)  # (..., n_hash)

    def lookup(self, params, buffers, ids):
        return params["M"][self._rows(buffers, ids)].sum(dim=-2)

    def logits(self, params, buffers, h):
        scores = promote_matmul(h, params["M"].T)
        rows = self._rows(buffers, torch.arange(self.d1, device=h.device))  # (d1, n_hash)
        return sum(scores[..., rows[:, j]] for j in range(self.n_hash))

    def sketch_matrix(self, buffers) -> np.ndarray:
        rows = self._rows(buffers, torch.arange(self.d1)).numpy()
        return _one_hot_sketch(self.d1, self.k, rows.T)


@dataclasses.dataclass(frozen=True)
class CEConcat:
    """Shi et al. 2020 compositional embeddings, hashed variant with
    concatenation: c tables of (k, d2/c); block-diagonal M."""

    d1: int
    d2: int
    k: int
    c: int = 4
    seed_salt: int = 0
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.d2 % self.c:
            raise ValueError(f"CEConcat needs c | d2, got {self}")

    @classmethod
    def from_budget(cls, d1, d2, budget, c=4, **kw):
        return cls(d1, d2, k=min(d1, _split_budget_rows(budget, d2)), c=c, **kw)

    @property
    def dsub(self) -> int:
        return self.d2 // self.c

    @property
    def n_params(self) -> int:
        return self.k * self.d2

    def init_buffers(self):
        hs = hashing.make_hashes(self.seed_salt * 7919 + 33, self.c, self.k)
        return {"hs": tuple((h.a, h.b) for h in hs)}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2)
        tables = _randn(generator, (self.c, self.k, self.dsub), scale, self.dtype, device)
        return {"tables": tables}, self.init_buffers()

    def _rows(self, buffers, ids):
        return _hash_rows(buffers["hs"], ids, self.k, 0)  # (c, ...)

    def lookup(self, params, buffers, ids):
        rows = self._rows(buffers, ids)
        pieces = torch.stack([params["tables"][i][rows[i]] for i in range(self.c)], dim=-2)
        return pieces.reshape(*ids.shape, self.d2)

    def logits(self, params, buffers, h):
        hc = h.reshape(*h.shape[:-1], self.c, self.dsub)
        rows = self._rows(buffers, torch.arange(self.d1, device=h.device))  # (c, d1)
        out = None
        for i in range(self.c):
            scores = promote_matmul(hc[..., i, :], params["tables"][i].T)  # (..., k)
            out = scores[..., rows[i]] if out is None else out + scores[..., rows[i]]
        return out

    def sketch_matrix(self, buffers) -> np.ndarray:
        """H (d1, c*k) against block-diagonal M."""
        rows = self._rows(buffers, torch.arange(self.d1)).numpy()
        return _one_hot_sketch(self.d1, self.c * self.k,
                               [i * self.k + rows[i] for i in range(self.c)])

    # --- universal fusion -----------------------------------------------

    @property
    def fuse_spec(self) -> FuseSpec:
        """c hashed columns, one table each: CCE's shape without the
        learned pointer and the helper table (T=1)."""
        return FuseSpec(cols=self.c, n_tables=1, k=self.k, dsub=self.dsub)

    def fuse_slab(self, params):
        return params["tables"][:, None]  # (c, 1, k, dsub)

    def unfuse_slab(self, slab):
        return {"tables": slab[:, 0]}

    def fuse_rows(self, buffers, ids):
        return self._rows(buffers, ids).to(torch.int32)[..., None]  # (c, B, 1)

    def fuse_rows_np(self, buffers, ids):
        ids = np.asarray(ids)
        return np.stack(
            [hashing.multiply_shift_np(ids, a, b, self.k) for a, b in buffers["hs"]]
        )[..., None]


@dataclasses.dataclass(frozen=True)
class ROBE:
    """Desai et al. 2022: chunks read from one flat array with wrap-around."""

    d1: int
    d2: int
    m: int  # flat array length
    c: int = 4
    seed_salt: int = 0
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.d2 % self.c:
            raise ValueError(f"ROBE needs c | d2, got {self}")

    @classmethod
    def from_budget(cls, d1, d2, budget, c=4, **kw):
        return cls(d1, d2, m=max(d2, min(d1 * d2, budget)), c=c, **kw)

    @property
    def dsub(self) -> int:
        return self.d2 // self.c

    @property
    def n_params(self) -> int:
        return self.m

    def init_buffers(self):
        hs = hashing.make_hashes(self.seed_salt * 7919 + 44, self.c, self.m)
        return {"hs": tuple((h.a, h.b) for h in hs)}

    def init(self, generator: torch.Generator, device="cuda"):
        scale = 1.0 / math.sqrt(self.d2)
        return {"flat": _randn(generator, (self.m,), scale, self.dtype, device)}, \
            self.init_buffers()

    def lookup(self, params, buffers, ids):
        start = _hash_rows(buffers["hs"], ids, self.m, -1)  # (..., c)
        offs = torch.arange(self.dsub, device=ids.device)
        idx = (start[..., None] + offs) % self.m  # (..., c, dsub)
        return params["flat"][idx].reshape(*ids.shape, self.d2)

    def logits(self, params, buffers, h):
        # chunks overlap arbitrarily: no small-matmul factorisation
        return _chunked_logits(self, params, buffers, h)

    def sketch_matrix(self, buffers) -> np.ndarray:
        raise NotImplementedError("ROBE's H is structured over chunks; see tests")


def _chunked_logits(method, params, buffers, h, chunk: int = 8192):
    """The default output head: vocabulary embeddings materialised in
    chunks of ``chunk`` ids."""
    outs = []
    for s in range(0, method.d1, chunk):
        ids = torch.arange(s, min(s + chunk, method.d1), device=h.device)
        emb = method.lookup(params, buffers, ids)  # (chunk, d2)
        outs.append(promote_matmul(h, emb.T))
    return torch.cat(outs, dim=-1)


def _mish(v: torch.Tensor) -> torch.Tensor:
    """``v * tanh(softplus(v))`` with softplus as ``logaddexp(v, 0)``, as
    ``jax.nn.softplus`` computes it (``torch.nn.functional.softplus``
    switches to the identity above a threshold)."""
    return v * torch.tanh(torch.logaddexp(v, torch.zeros_like(v)))


@dataclasses.dataclass(frozen=True)
class DHE:
    """Kang et al. 2021 deep hash embeddings: ``n_hash`` pseudo-random
    features in [-1, 1] -> an MLP with Mish (2 hidden layers of width
    ``width``, solved from the parameter budget)."""

    d1: int
    d2: int
    width: int
    n_hash: int
    seed_salt: int = 0
    dtype: Any = torch.float32

    @classmethod
    def from_budget(cls, d1, d2, budget, **kw):
        # params ~= w*w + w*w + w*d2  (2 hidden layers of width w)
        w = int((-d2 + math.sqrt(d2 * d2 + 8 * budget)) / 4)
        w = max(8, w)
        return cls(d1, d2, width=w, n_hash=w, **kw)

    @property
    def n_params(self) -> int:
        w = self.width
        return w * w + w * w + w * self.d2 + 2 * w + self.d2

    def init_buffers(self):
        """int32 coefficient arrays; ``a`` wraps negative in int32 as
        numpy's does."""
        rng = np.random.default_rng(self.seed_salt * 7919 + 55)
        a = (rng.integers(0, 2**31 - 1, self.n_hash, dtype=np.int32) * 2 + 1).astype(np.int32)
        b = rng.integers(0, 2**31 - 1, self.n_hash, dtype=np.int32)
        return {"a": a, "b": b}

    def init(self, generator: torch.Generator, device="cuda"):
        w = self.width
        params = {
            "w1": _randn(generator, (self.n_hash, w), 1 / math.sqrt(self.n_hash), self.dtype,
                         device),
            "b1": torch.zeros((w,), dtype=self.dtype, device=device),
            "w2": _randn(generator, (w, w), 1 / math.sqrt(w), self.dtype, device),
            "b2": torch.zeros((w,), dtype=self.dtype, device=device),
            "w3": _randn(generator, (w, self.d2), 1 / math.sqrt(w), self.dtype, device),
            "b3": torch.zeros((self.d2,), dtype=self.dtype, device=device),
        }
        b = self.init_buffers()
        return params, {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def _features(self, buffers, ids):
        """The JAX package's uint32 feature hash, in int64 masked to 32
        bits, then mapped to [-1, 1) in float32."""
        mask = hashing._MASK32
        x = (ids.to(torch.int64) & mask)[..., None]
        a = torch.as_tensor(buffers["a"], device=ids.device).to(torch.int64) & mask
        b = torch.as_tensor(buffers["b"], device=ids.device).to(torch.int64) & mask
        h = (hashing._mul32(x, a) + b) & mask
        h = hashing._mul32(h ^ (h >> 15), hashing._MERSENNE)
        h = h ^ (h >> 13)
        return (h.to(torch.float32) / 2.0**31 - 1.0).to(self.dtype)

    def lookup(self, params, buffers, ids):
        x = self._features(buffers, ids)
        x = _mish(x @ params["w1"] + params["b1"])
        x = _mish(x @ params["w2"] + params["b2"])
        return x @ params["w3"] + params["b3"]

    def logits(self, params, buffers, h):
        return _chunked_logits(self, params, buffers, h)


@dataclasses.dataclass(frozen=True)
class TensorTrain:
    """Yin et al. 2021 TT-Rec: a 3-core tensor-train factorisation."""

    d1: int
    d2: int
    rank: int
    seed_salt: int = 0
    dtype: Any = torch.float32

    @classmethod
    def from_budget(cls, d1, d2, budget, **kw):
        q = cls._factor3(d1)
        p = cls._factor3(d2)
        # params(r) = q1*p1*r + q2*p2*r^2 + q3*p3*r
        a = q[1] * p[1]
        b = q[0] * p[0] + q[2] * p[2]
        r = int((-b + math.sqrt(b * b + 4 * a * budget)) / (2 * a))
        return cls(d1, d2, rank=max(1, r), **kw)

    @staticmethod
    def _factor3(n: int) -> tuple[int, int, int]:
        """q1*q2*q3 >= n with qi ~ n^(1/3)."""
        q = int(math.ceil(n ** (1 / 3)))
        return (q, q, int(math.ceil(n / (q * q))))

    @property
    def qs(self):
        return self._factor3(self.d1)

    @property
    def ps(self):
        # an exact factorisation of d2 into 3 factors
        d2 = self.d2
        p1 = _largest_divisor_leq(d2, round(d2 ** (1 / 3)))
        rest = d2 // p1
        p2 = _largest_divisor_leq(rest, round(math.sqrt(rest)))
        return (p1, p2, rest // p2)

    @property
    def n_params(self) -> int:
        q, p, r = self.qs, self.ps, self.rank
        return q[0] * p[0] * r + r * q[1] * p[1] * r + r * q[2] * p[2]

    def init_buffers(self):
        return {}

    def init(self, generator: torch.Generator, device="cuda"):
        q, p, r = self.qs, self.ps, self.rank
        s = (1.0 / math.sqrt(self.d2)) ** (1 / 3)
        params = {
            "g1": _randn(generator, (q[0], p[0], r), s, self.dtype, device),
            "g2": _randn(generator, (q[1], r, p[1], r), s, self.dtype, device),
            "g3": _randn(generator, (q[2], r, p[2]), s, self.dtype, device),
        }
        return params, self.init_buffers()

    def lookup(self, params, buffers, ids):
        """Core indices as the jitted JAX gather takes them: a negative
        first index wraps once, then clamps into its core, as does one past
        the end (floor ``//`` and ``%`` keep the other two in range)."""
        q = self.qs
        ids = ids.to(torch.int64)
        i1 = ids // (q[1] * q[2])
        i1 = torch.where(i1 < 0, i1 + q[0], i1).clamp(0, q[0] - 1)
        i2 = (ids // q[2]) % q[1]
        i3 = ids % q[2]
        g1 = params["g1"][i1]  # (..., p1, r)
        g2 = params["g2"][i2]  # (..., r, p2, r)
        g3 = params["g3"][i3]  # (..., r, p3)
        x = torch.einsum("...ar,...rbs->...abs", g1, g2)  # (..., p1, p2, r)
        x = torch.einsum("...abs,...sc->...abc", x, g3)  # (..., p1, p2, p3)
        return x.reshape(*ids.shape, self.d2)

    def logits(self, params, buffers, h):
        return _chunked_logits(self, params, buffers, h)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


METHODS = {
    "full": FullTable,
    "hash": HashingTrick,
    "hemb": HashEmbedding,
    "ce": CEConcat,
    "robe": ROBE,
    "dhe": DHE,
    "tt": TensorTrain,
}


def lookup_many_loop(tables, params_seq, buffers_seq, ids):
    """The batched lookup of tables without a fused one: feature by
    feature.  ids (B, F) -> (B, F, d2)."""
    return torch.stack(
        [t.lookup(params_seq[f], buffers_seq[f], ids[:, f]) for f, t in enumerate(tables)],
        dim=1,
    )


def make_table(method: str, d1: int, d2: int, budget: int | None = None, **kw):
    """Budget-driven construction of any method, "cce" included."""
    if method == "cce":
        from repro_torch.core.cce import CCE

        return CCE.from_budget(d1, d2, budget, **kw)
    if method == "full":
        kw.pop("c", None)
        kw.pop("seed_salt", None)
        return FullTable(d1, d2, **kw)
    cls = METHODS[method]
    if method in ("hash", "hemb", "dhe", "tt"):
        kw.pop("c", None)
    return cls.from_budget(d1, d2, budget, **kw)
