"""Two-phase VCMR/VR corpus evaluation (the serving path, and VR alone in
``downstream``) and its metrics, the caption metrics, and the
pretraining validators."""
