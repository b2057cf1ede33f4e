from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointCorruptionError, latest_step, load_checkpoint, load_leaves,
    save_checkpoint,
)
