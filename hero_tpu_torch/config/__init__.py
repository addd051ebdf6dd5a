"""Model configuration (copies of hero_tpu/config/model_config.py)."""
