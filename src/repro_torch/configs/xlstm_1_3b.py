"""xlstm-1.3b [xlstm] — 48 blocks d_model=2048 4H d_ff=0 vocab=50304;
mLSTM and sLSTM blocks at the xLSTM[7:1] ratio (one sLSTM block after
every 7 mLSTM blocks).  [arXiv:2405.04517; unverified]

No KV cache at all: the decode state is O(1) in the sequence length (the
mLSTM's (C, n, m) and the sLSTM's (c, n, h, m) a block and slot).  The
CCE token table and the factored CCE head are each c=4, T=2, k=1572,
dsub=512 under the 16x budget.
"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,
    pos_emb="none",
    emb_method="cce",
    emb_budget=50304 * 2048 // 16,
    dtype=torch.bfloat16,
    train_microbatch=32,
)
