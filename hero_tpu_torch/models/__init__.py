"""Model stack, functional PyTorch over parameter dicts.

Layering as in hero_tpu/models: nn -> transformer/embed -> encoder ->
model (backbone) -> pretrain / vcmr heads.
"""
