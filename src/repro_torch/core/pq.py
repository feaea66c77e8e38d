"""Post-training product quantisation: the paper's post-hoc baseline
(Figure 4a's "Product Quantization" line), the port of the JAX package's
``core/pq.py``.

PQ splits a trained table T (d1, d2) into c column blocks and k-means
each block into k codewords: T ~= concat_i( M_i[a_i(id)] ).  Unlike CCE it
runs only after training, so it never reduces training memory.  The
quantised table is a CE-concat structure with learned instead of hashed
rows.

With ``sample`` the k-means of each block runs on ``sample`` rows drawn
without replacement, and every row of the table is then assigned to its
nearest codeword, ``CHUNK`` rows at a time through ``kmeans.assign_chunks``:
on a CUDA table each chunk is ONE assignment-kernel launch for all c
blocks (as ``CCE.assign_all`` takes it), on a CPU table each block goes
through ``kmeans.assign``.  The row draws come from a ``torch.Generator``
seeded from the key and are not JAX's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.core import kmeans as km

CHUNK = 1 << 18  # rows an assignment launch, as DLRMConfig.emb_cluster_chunk


@dataclasses.dataclass(frozen=True)
class PQResult:
    codebooks: torch.Tensor  # (c, k, d2/c)
    assignments: torch.Tensor  # (c, d1) int32
    mse: float


def _sample(key, d1: int, n: int, device) -> torch.Tensor:
    """``n`` of ``range(d1)`` without replacement (int64 on ``device``)."""
    return torch.randperm(d1, generator=km._generator(key))[:n].to(device)


def assign_rows(table: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword of every row's block: (d1, d2) table, (c, k, dsub)
    codebooks -> (c, d1) int32, ``CHUNK`` rows at a time."""
    d1 = table.shape[0]
    c, _, dsub = codebooks.shape
    blocks = table.reshape(d1, c, dsub).to(torch.float32)
    out = torch.empty((c, d1), dtype=torch.int32, device=table.device)
    chunks = ((s, blocks[s: s + CHUNK].movedim(1, 0)) for s in range(0, d1, CHUNK))  # (c, n, dsub)
    return km.assign_chunks(chunks, codebooks, out)


def product_quantize(key, table: torch.Tensor, k: int, c: int = 4, *, niter: int = 50,
                     sample: int | None = None) -> PQResult:
    """Quantise a trained table into c codebooks of k codewords each.
    ``key`` is a ``repro_torch.random`` key; block i clusters with
    ``fold_in(key, i)``."""
    d1, d2 = table.shape
    if d2 % c:
        raise ValueError(f"product_quantize needs c | d2, got d2={d2}, c={c}")
    dsub = d2 // c
    blocks = table.reshape(d1, c, dsub)
    codebooks, assigns = [], []
    for i in range(c):
        x = blocks[:, i]
        ki = jr.fold_in(key, i)
        if sample is not None and sample < d1:
            res = km.kmeans(ki, x[_sample(ki, d1, sample, x.device)], k, niter=niter)
            assigns.append(None)
        else:
            res = km.kmeans(ki, x, k, niter=niter)
            assigns.append(res.assignments)
        codebooks.append(res.centroids)
    codebooks = torch.stack(codebooks)
    if any(a is None for a in assigns):
        assignments = assign_rows(table, codebooks)
    else:
        assignments = torch.stack(assigns)
    mse = 0.0
    for i in range(c):
        diff = blocks[:, i].to(torch.float32) - codebooks[i][assignments[i].to(torch.int64)]
        mse += float((diff ** 2).mean())
    return PQResult(codebooks=codebooks, assignments=assignments, mse=mse / c)


def pq_lookup(pq: PQResult, ids: torch.Tensor) -> torch.Tensor:
    """Reconstruct embeddings for ``ids`` from the PQ codebooks."""
    c, _, dsub = pq.codebooks.shape
    rows = pq.assignments[:, ids].to(torch.int64)  # (c, ...)
    pieces = torch.stack([pq.codebooks[i][rows[i]] for i in range(c)], dim=-2)
    return pieces.reshape(*ids.shape, c * dsub)


def pq_table(pq: PQResult) -> torch.Tensor:
    """The full reconstructed table (tests, small vocabularies)."""
    d1 = pq.assignments.shape[1]
    return pq_lookup(pq, torch.arange(d1, device=pq.assignments.device))
