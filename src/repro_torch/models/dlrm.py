"""DLRM (Naumov et al. 2019), the paper's recommendation model.

13 dense features -> bottom MLP; 26 categorical features -> one embedding
table each, behind an ``EmbeddingCollection`` (one fused supertable
lookup for the compressed Criteo configuration); pairwise dot-product
interaction; top MLP -> 1 logit.

Parameters are the JAX package's pytree layout as plain dicts and lists
of tensors: ``{"bottom": [{"w", "b"}, ...], "emb": [group, ...],
"top": [...]}`` and buffers ``{"emb": [[feature buffers, ...], ...]}``,
so ``convert.py`` carries them across unchanged.  A CUDA tensor always
goes through the lookup kernel; there is no gather fallback.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence

import torch

from repro_torch.core import embeddings as emb_lib
from repro_torch.core.collection import EmbeddingCollection


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: tuple[int, ...]  # one per categorical feature (26 on Criteo)
    n_dense: int = 13
    emb_dim: int = 16
    bottom_mlp: tuple[int, ...] = (512, 256, 64, 16)
    top_mlp: tuple[int, ...] = (512, 256, 1)
    # per-table compression: method + cap on each table's params
    emb_method: str = "full"
    emb_param_cap: int = 0  # 0 = uncapped
    emb_c: int = 4
    # codebook rows round up to a multiple of this (model-shard count)
    emb_k_multiple: int = 1
    dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def _build_table(self, i: int):
        v = self.vocab_sizes[i]
        cap = self.emb_param_cap
        if self.emb_method == "full" or not cap or v * self.emb_dim <= cap:
            # small tables stay uncompressed (paper: full table for small
            # features, compressed for the big ones)
            return emb_lib.make_table("full", v, self.emb_dim, dtype=self.dtype)
        return emb_lib.make_table(
            self.emb_method, v, self.emb_dim, budget=cap, c=self.emb_c,
            dtype=self.dtype, seed_salt=i,
        )

    @functools.cached_property
    def collection(self) -> EmbeddingCollection:
        return EmbeddingCollection.build(
            tuple(self._build_table(i) for i in range(self.n_sparse)),
            k_multiple=self.emb_k_multiple,
        )

    def n_emb_params(self) -> int:
        return sum(t.n_params for t in self.collection.tables)


def _init_mlp(generator, sizes: Sequence[int], dtype, device):
    return [
        {
            "w": (torch.randn((a, b), generator=generator) / math.sqrt(a)).to(
                device=device, dtype=dtype
            ),
            "b": torch.zeros((b,), dtype=dtype, device=device),
        }
        for a, b in zip(sizes[:-1], sizes[1:])
    ]


def _apply_mlp(params, x, final_act: bool = False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def init(cfg: DLRMConfig, generator: torch.Generator, device="cuda"):
    """(params, buffers) with float draws from ``generator`` (they do not
    reproduce the JAX package's draws; tests carry its weights across
    with ``convert.py``) and integer buffers bit-exact with it."""
    params: dict[str, Any] = {
        "bottom": _init_mlp(generator, (cfg.n_dense, *cfg.bottom_mlp), cfg.dtype, device),
    }
    buffers: dict[str, Any] = {}
    params["emb"], buffers["emb"] = cfg.collection.init(generator, device)
    n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    top_in = cfg.bottom_mlp[-1] + n_pairs
    params["top"] = _init_mlp(generator, (top_in, *cfg.top_mlp), cfg.dtype, device)
    return params, buffers


def interact(params, cfg: DLRMConfig, dense, emb):
    """Everything after the embedding lookup: bottom MLP, pairwise dot
    interaction (upper triangle, no self, row-major pair order as
    ``jnp.triu_indices``), top MLP -> (B,) logits.  ``params`` needs only
    the ``bottom``/``top`` entries."""
    dense = dense.to(cfg.dtype)
    x0 = _apply_mlp(params["bottom"], dense, final_act=True)  # (B, emb_dim)
    V = torch.cat([x0[:, None, :], emb.to(cfg.dtype)], dim=1)
    inter = torch.bmm(V, V.transpose(1, 2))
    n = V.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=V.device)
    feats = torch.cat([x0, inter[:, iu, ju]], dim=-1)
    return _apply_mlp(params["top"], feats)[:, 0]


def forward(params, buffers, cfg: DLRMConfig, batch):
    """batch: {"dense": (B, 13) float, "sparse": (B, 26) ids} and/or
    {"rows": (B, rows_n_cols, rows_n_tables) int32 host-translated rows}
    -> (B,) logits."""
    emb = cfg.collection.lookup_all(
        params["emb"], buffers["emb"], batch.get("sparse"), rows=batch.get("rows"),
    )  # (B, n_sparse, emb_dim): ONE fused lookup on Criteo
    return interact(params, cfg, batch["dense"], emb)
