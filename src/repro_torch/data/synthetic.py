"""Deterministic synthetic data pipelines (numpy, host side).

``clickstream_batches`` is a Criteo-like CTR stream for DLRM: 13 dense +
N categorical features, Zipf id frequencies like real click logs, and a
planted cluster structure (each id belongs to one of ``n_latent``
concepts, and the click probability depends on the concepts).
``lm_token_batches`` is a power-law Markov token stream for the LM.  A
batch is fully determined by (seed, step, host), so any host can
regenerate any shard.  Same generators as the JAX package's, so both
sides see the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClickstreamConfig:
    vocab_sizes: tuple[int, ...] = (1000, 5000, 20000, 100, 50000)
    n_dense: int = 13
    n_latent: int = 32  # latent concepts per feature (the planted clusters)
    zipf_a: float = 1.1  # id frequency skew
    noise: float = 0.5  # logit noise
    seed: int = 0


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def planted_embedding_model(cfg: ClickstreamConfig):
    """The ground truth: id -> latent concept maps and concept weights."""
    rng = np.random.default_rng(cfg.seed)
    concept_of = [rng.integers(0, cfg.n_latent, size=v) for v in cfg.vocab_sizes]
    concept_w = [rng.normal(0, 1.0, size=cfg.n_latent) for _ in cfg.vocab_sizes]
    dense_w = rng.normal(0, 0.3, size=cfg.n_dense)
    return concept_of, concept_w, dense_w


def clickstream_batches(
    cfg: ClickstreamConfig, batch: int, *, start_step: int = 0,
    host_id: int = 0, n_hosts: int = 1,
) -> Iterator[dict]:
    """Yields {"dense", "sparse", "label", "step"} batches."""
    concept_of, concept_w, dense_w = planted_embedding_model(cfg)
    probs = [_zipf_probs(v, cfg.zipf_a) for v in cfg.vocab_sizes]
    step = start_step
    while True:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + host_id * n_hosts
        )
        dense = rng.normal(0, 1, size=(batch, cfg.n_dense)).astype(np.float32)
        sparse = np.stack(
            [rng.choice(len(p), size=batch, p=p) for p in probs], axis=1
        ).astype(np.int32)
        logit = dense @ dense_w
        for f in range(len(cfg.vocab_sizes)):
            logit = logit + concept_w[f][concept_of[f][sparse[:, f]]]
        logit = logit + rng.normal(0, cfg.noise, size=batch)
        label = (rng.uniform(size=batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label, "step": step}
        step += 1


def lm_token_batches(
    vocab: int, batch: int, seq: int, *, seed: int = 0, start_step: int = 0,
    host_id: int = 0, n_hosts: int = 1, n_codebooks: int = 0,
) -> Iterator[dict]:
    """Yields {"tokens": (batch, seq) int32, "step"}, or (batch, seq,
    n_codebooks) for the audio family, each codebook a stream of its own:
    token t+1 follows a fixed random successor map with probability 0.7,
    else a fresh draw from a Zipf(1.2) prior."""
    rng0 = np.random.default_rng(seed)
    succ = rng0.integers(0, vocab, size=vocab)
    prior = _zipf_probs(vocab, 1.2)
    step = start_step
    while True:
        rng = np.random.default_rng((seed * 9_999_991 + step) * 257 + host_id * n_hosts)
        shape = (batch, seq, n_codebooks) if n_codebooks else (batch, seq)
        lead = shape[:1] + shape[2:]  # one draw a sequence (and codebook) a position
        toks = np.empty(shape, np.int32)
        toks[:, 0] = rng.choice(vocab, size=lead, p=prior)
        for t in range(1, seq):
            follow = rng.uniform(size=lead) < 0.7
            rand = rng.choice(vocab, size=lead, p=prior)
            toks[:, t] = np.where(follow, succ[toks[:, t - 1]], rand)
        yield {"tokens": toks, "step": step}
        step += 1
