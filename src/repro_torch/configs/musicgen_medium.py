"""musicgen-medium [audio] — decoder-only over EnCodec tokens: 48L
d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 per codebook, 4
codebooks.  [arXiv:2306.05284; hf]

The backbone only: the EnCodec frontend is a stub, and the inputs are the
4 codebook token streams (the delay pattern applied upstream).  The model
sums the 4 codebook embeddings of a frame (one table of 4 x 2048 rows,
codebook j offset by j x 2048) and predicts all 4 codebooks through one
head of 4 x 2048 rows.  LayerNorm, GELU, sinusoidal positions.  The table
stays full: 8192 rows leave CCE nothing to compress.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    n_codebooks=4,
    norm="layernorm",
    act="gelu",
    pos_emb="sinusoidal",
    emb_method="full",
    dtype=torch.bfloat16,
    train_microbatch=32,
)
