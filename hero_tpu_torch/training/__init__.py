"""Training: AdamW with HERO's parameter groups, LR schedules, the step."""
