"""Model configuration objects (copied from ``hero_tpu/config/model_config.py``).

``TransformerConfig`` is one transformer stack; ``HeroConfig`` holds the
f (cross-modal), c (temporal) and q (query) stacks.  The same
``config/hero_*.json`` files load through ``HeroConfig.from_json``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """One transformer stack (f/c/q/d sub-encoder) configuration."""

    hidden_size: int = 768
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 514
    type_vocab_size: int = 2
    vocab_size: int = 50272
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    # Decoder-only (TVC) fields; ignored by encoders.
    share_wemb: bool = True
    label_smoothing: float = 0.0

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TransformerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        return self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HeroConfig:
    """Composite config: f (cross-modal), c (temporal), q (query), d (decoder).

    ``d_config`` is only present for captioning (hero_tvc.json).
    """

    f_config: TransformerConfig
    c_config: TransformerConfig
    q_config: Optional[TransformerConfig] = None
    d_config: Optional[TransformerConfig] = None
    vfeat_dim: int = 4352
    max_frm_seq_len: int = 100
    max_clip_len: int = 100
    nce_temp: float = 1.0

    @classmethod
    def from_json(cls, path: str, **overrides) -> "HeroConfig":
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict(d, **overrides)

    @classmethod
    def from_dict(cls, d: dict[str, Any], **overrides) -> "HeroConfig":
        kw: dict[str, Any] = {}
        for key in ("f_config", "c_config", "q_config", "d_config"):
            if key in d and d[key] is not None:
                kw[key] = TransformerConfig.from_dict(d[key])
        for key in ("vfeat_dim", "max_frm_seq_len", "max_clip_len",
                    "nce_temp"):
            if key in d:
                kw[key] = d[key]
        kw.update(overrides)
        return cls(**kw)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key in ("f_config", "c_config", "q_config", "d_config"):
            sub = getattr(self, key)
            if sub is not None:
                out[key] = sub.to_dict()
        out.update(vfeat_dim=self.vfeat_dim,
                   max_frm_seq_len=self.max_frm_seq_len,
                   max_clip_len=self.max_clip_len, nce_temp=self.nce_temp)
        return out

    def replace(self, **kw) -> "HeroConfig":
        return dataclasses.replace(self, **kw)


def tiny_hero_config(vocab_size: int = 128, hidden: int = 32,
                     heads: int = 4, vfeat_dim: int = 64,
                     max_clip_len: int = 16) -> HeroConfig:
    """A miniature config for unit tests (fast on CPU)."""
    base = TransformerConfig(
        hidden_size=hidden, num_hidden_layers=2, num_attention_heads=heads,
        intermediate_size=hidden * 4, max_position_embeddings=64,
        vocab_size=vocab_size, type_vocab_size=2)
    return HeroConfig(
        f_config=base,
        c_config=base.replace(num_hidden_layers=1),
        q_config=base.replace(num_hidden_layers=0, type_vocab_size=1),
        d_config=base.replace(num_hidden_layers=1),
        vfeat_dim=vfeat_dim, max_frm_seq_len=max_clip_len,
        max_clip_len=max_clip_len)


def flagship_config() -> HeroConfig:
    """The published HERO width: hidden 768, 12 heads, f-encoder 6 layers,
    c-encoder 3 layers, RoBERTa vocab padded to 50272, 4352-d frame
    features (``bench.py`` flagship)."""
    base = TransformerConfig(hidden_size=768, num_hidden_layers=6,
                             num_attention_heads=12, intermediate_size=3072,
                             max_position_embeddings=514,
                             vocab_size=50272, type_vocab_size=2)
    return HeroConfig(
        f_config=base,
        c_config=base.replace(num_hidden_layers=3),
        q_config=base.replace(num_hidden_layers=0, type_vocab_size=1),
        vfeat_dim=4352, max_frm_seq_len=100, max_clip_len=100)


TVC_CONFIG_JSON = (Path(__file__).resolve().parents[2] / "config"
                   / "hero_tvc.json")


def flagship_tvc_config() -> HeroConfig:
    """The TVC model of ``config/hero_tvc.json``, as the JAX package loads
    it: the flagship backbone (f-encoder 6 layers, c-encoder 3) and a
    2-layer decoder of hidden 768, 12 heads, FFN 3072, vocab 50272 and
    1024 positions."""
    return HeroConfig.from_json(str(TVC_CONFIG_JSON))
