"""Training of the port (``repro/train``): optimizers, the microbatched
train step, checkpoints in the JAX package's files, seeded data."""

from .checkpoint import list_checkpoints, restore_checkpoint, restore_latest, save_checkpoint
from .data import synth_batch
from .optimizer import AdamW, Adafactor, make_optimizer, opt_state_specs
from .train_step import effective_microbatches, make_train_step, microbatch_split

__all__ = ["AdamW", "Adafactor", "effective_microbatches", "list_checkpoints",
           "make_optimizer", "make_train_step", "microbatch_split", "opt_state_specs",
           "restore_checkpoint",
           "restore_latest", "save_checkpoint", "synth_batch"]
