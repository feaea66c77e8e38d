from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    sgd,
)
from repro_torch.optim.remap import (  # noqa: F401
    remap_opt_state,
    zeros_like_moments,
)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_grad_transform,
    int8_compress,
    int8_decompress,
)
