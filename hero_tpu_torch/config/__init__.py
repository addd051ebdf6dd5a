"""Model configuration and the pretraining options (copies of
hero_tpu/config/model_config.py and hero_tpu/config/opts.py)."""
