"""Model configuration of the LM stack: the JAX package's ``ModelConfig``
(``repro/models/config.py``) with torch dtypes.

One frozen dataclass carries every field of the JAX package's, so a
config crosses between the packages field by field; the port runs every
family of the JAX package: dense, hybrid, xlstm, vlm, moe and audio
(``models/lm.py``).  Configs are
built in ``repro_torch/configs/<arch>.py``; ``reduced()`` gives the
small same-family variant the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | xlstm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    sliding_window: int = 0  # 0 = full attention
    parallel_block: bool = False  # command-r style parallel attn+FFN
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    logit_softcap: float = 0.0
    emb_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    pos_emb: str = "rope"  # rope | sinusoidal | none

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid (hymba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # xLSTM
    slstm_every: int = 0  # 1 sLSTM per this many blocks (0 = none)

    # modality frontend stubs
    n_patches: int = 0  # vlm: number of precomputed patch embeddings
    n_codebooks: int = 0  # audio: EnCodec codebooks summed at input

    # embedding-table compression (the paper's technique)
    emb_method: str = "full"  # full | hash | hemb | ce | robe | dhe | tt | cce
    emb_budget: int = 0  # parameter budget for compressed tables (0=full)
    emb_c: int = 4  # CCE / CE columns
    tie_embeddings: bool = False

    # numerics
    dtype: Any = torch.bfloat16  # activations/weights compute dtype
    param_dtype: Any = torch.float32

    # knobs of the JAX package's distributed training; carried so that a
    # config crosses whole, read here only by ``attn_impl``
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True
    train_microbatch: int = 16
    moe_group: int = 2048
    attn_impl: str = "dense"  # dense | chunked | dense_bf16p
    attn_chunk: int = 512
    seq_shard: bool = False
    moe_impl: str = "einsum"
    zero2_grads: bool = False
    parallelism: str = "tp"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in sequence length (no KV cache)."""
        return self.family == "xlstm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (sliding-window or recurrent)."""
        return self.family in ("xlstm",) or (
            self.family == "hybrid" and self.sliding_window > 0
        )

    def n_params(self) -> int:
        """Total parameter count, analytic and as the JAX package counts
        it: biases, the hybrid branch norms and the vlm's ``patch_proj``
        are left out, every xlstm block is counted by ``_xlstm_params``,
        and the audio family's token table as vocab x d, where its init
        holds vocab x n_codebooks rows (its head is counted whole)."""
        d, L = self.d_model, self.n_layers
        attn = _attn_params(self)
        if self.family == "xlstm":
            blocks = L * _xlstm_params(self)
        elif self.family == "moe":
            blocks = L * (attn + self.n_experts * 3 * d * self.d_ff + d * self.n_experts + 2 * d)
        elif self.family == "hybrid":
            blocks = L * (attn + _ssm_params(self) + 3 * d * self.d_ff + 2 * d)
        else:
            ffn = (3 if self.act == "swiglu" else 2) * d * self.d_ff
            blocks = L * (attn + ffn + 2 * d)
        tables = 1 if self.tie_embeddings else 1 + (self.n_codebooks or 1)
        emb = self.vocab * d * tables
        if self.emb_method != "full" and self.emb_budget:
            emb = self.emb_budget * tables
        return blocks + emb + d

    def n_active_params(self) -> int:
        """Parameters a token uses: ``n_params`` but for the moe family,
        whose FFN counts its top_k experts and the router.  As the JAX
        package counts it, the token table and the head count a full
        vocab x d each whatever ``emb_method`` is (under CCE far more than
        the tables hold)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        ffn = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        blocks = self.n_layers * (_attn_params(self) + ffn + 2 * d)
        return blocks + self.vocab * d * 2 + d

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU tests (the JAX package's
        ``reduced``)."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=257,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 4) if self.ssm_state else 0,
            n_patches=min(self.n_patches, 4) if self.n_patches else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            emb_budget=2048 if self.emb_method != "full" else 0,
            dtype=torch.float32,
            remat="none",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _attn_params(cfg: ModelConfig) -> int:
    """q, k, v and output projections of one layer, without biases."""
    d, hd = cfg.d_model, cfg.head_dim
    return d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d


def _ssm_params(cfg: ModelConfig) -> int:
    di, ds = cfg.ssm_inner, cfg.ssm_state
    d = cfg.d_model
    # in_proj (x+z), conv, dt/B/C proj, A, D, out_proj
    return (
        d * 2 * di
        + cfg.ssm_conv * di
        + di * (2 * ds + 1)
        + di * ds
        + di
        + di * d
    )


def _xlstm_params(cfg: ModelConfig) -> int:
    """The JAX package's count of one xlstm block (every block counted as
    an mLSTM block, its two gate projections as 2·di): the formula as it
    stands there, so that ``n_params`` equals the JAX package's.  The
    true count of xlstm-1.3b's init is lower (``chip_smoke.py`` prints
    both)."""
    d = cfg.d_model
    di = 2 * d  # mLSTM up-projection factor 2
    m = 2 * d * di + 3 * di * di // cfg.n_heads * cfg.n_heads + 2 * di + di * d
    return m + 2 * d
