"""Model configuration, the pretraining options and the bucket shapes
(copies of hero_tpu/config/model_config.py, hero_tpu/config/opts.py and
hero_tpu/config/shapes.py)."""

from .model_config import HeroConfig, TransformerConfig, tiny_hero_config
from .shapes import BucketShape, round_up, tiny_bucket

__all__ = ["HeroConfig", "TransformerConfig", "tiny_hero_config",
           "BucketShape", "round_up", "tiny_bucket"]
