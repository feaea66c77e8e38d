"""DLRM on (synthetic) Criteo -- the paper's own architecture.

26 categorical features with the Criteo Kaggle vocabulary sizes, 13 dense
features, emb_dim 16.  With the CCE cap below the 17 large features
become CCE tables (k = 250) and the 9 small ones stay full; all 26 fuse
into one universal supertable of 104 columns, T=2, k_pad=305, dsub=4.
"""
from repro_torch.models.dlrm import DLRMConfig

# Criteo Kaggle vocab sizes (the published counts)
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)

CONFIG = DLRMConfig(
    vocab_sizes=CRITEO_KAGGLE_VOCABS,
    n_dense=13,
    emb_dim=16,
    bottom_mlp=(512, 256, 64, 16),
    top_mlp=(512, 256, 1),
    emb_method="cce",
    emb_param_cap=8000,  # the paper's Fig. 4a operating point
)


def reduced(emb_method: str = "cce", cap: int = 512, k_multiple: int = 1) -> DLRMConfig:
    """Small synthetic-Criteo configuration for CPU runs."""
    return DLRMConfig(
        vocab_sizes=(1000, 5000, 20000, 100, 50000),
        n_dense=13,
        emb_dim=16,
        bottom_mlp=(64, 32, 16),
        top_mlp=(64, 1),
        emb_method=emb_method,
        emb_param_cap=cap,
        emb_k_multiple=k_multiple,
    )
