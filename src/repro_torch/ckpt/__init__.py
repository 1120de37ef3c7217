"""repro_torch.ckpt — checkpoints in the reference's npz + manifest
format."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer, checkpoint_metadata, latest_step, restore_checkpoint,
    restore_values, save_checkpoint)
