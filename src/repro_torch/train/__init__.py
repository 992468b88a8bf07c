"""Training substrate (the JAX package's ``train/``): AdamW with f32 master
weights and a cosine schedule, and checkpointing in the reference's layout."""
from repro_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.train.optimizer import adamw, cosine_lr

__all__ = [
    "CheckpointManager",
    "adamw",
    "cosine_lr",
    "load_checkpoint",
    "save_checkpoint",
]
