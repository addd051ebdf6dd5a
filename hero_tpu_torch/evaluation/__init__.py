"""Two-phase VCMR/VR corpus evaluation (the serving path) and its metrics,
and the pretraining validators."""
