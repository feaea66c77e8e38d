from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
