"""Training: AdamW with HERO's parameter groups, LR schedules, the step,
and checkpoints in the JAX package's file layout."""
