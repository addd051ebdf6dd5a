"""Which parameter and moment leaves shard over which ranks (counterpart of
the placement half of ``hero_tpu/parallel/mesh.py``).

Where the JAX package hands GSPMD a ``PartitionSpec`` a leaf, the port
reads a :class:`Shard` a leaf (None: the leaf stays whole on every rank)
and cuts, steps and gathers the leaves itself
(``training/step.shard_state`` / ``gather_state``, the ZeRO-1 update,
``models/transformer``'s tensor-parallel blocks).  The functions hold no
torch state: they read the shapes and paths of a parameter tree and
return one entry a leaf, in ``training/optim.tree_leaves`` order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from hero_tpu_torch.training import optim


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf cut into equal parts on ``dim``; with ``blocks`` > 1 the dim
    holds that many equal blocks (the fused query, key and value rows),
    each cut alike, and a part is its slice of every block."""
    dim: int
    blocks: int = 1


def split(t: torch.Tensor, shard: Shard, r: int, n: int) -> torch.Tensor:
    """Part ``r`` of ``n`` of ``t`` (contiguous)."""
    blocks = t.chunk(shard.blocks, shard.dim)
    return torch.cat([b.chunk(n, shard.dim)[r] for b in blocks],
                     shard.dim).contiguous()


def join(parts: Sequence[torch.Tensor], shard: Shard) -> torch.Tensor:
    """The leaf whose parts, in rank order, are ``parts`` (inverse of
    :func:`split`)."""
    per = [p.chunk(shard.blocks, shard.dim) for p in parts]
    return torch.cat([torch.cat([p[b] for p in per], shard.dim)
                      for b in range(shard.blocks)], shard.dim)


def zero1_opt_spec(params, n_shards: int) -> List[Optional[Shard]]:
    """ZeRO-1's AdamW moments (``hero_tpu/parallel/mesh.py:163-187``):
    each leaf shards its largest dim that ``n_shards`` divides (and that
    is at least ``n_shards``), the first such dim on ties; a 0-d, small or
    indivisible leaf stays whole."""
    def spec(leaf) -> Optional[Shard]:
        dims = sorted(range(leaf.ndim), key=lambda d: leaf.shape[d],
                      reverse=True)
        for d in dims:
            if leaf.shape[d] >= n_shards and leaf.shape[d] % n_shards == 0:
                return Shard(d)
        return None
    return [spec(t) for t in optim.tree_leaves(params)]


def tp_param_spec(params) -> List[Optional[Shard]]:
    """Tensor parallelism over the model ranks
    (``hero_tpu/parallel/mesh.py:246-280``), on the port's tree (PyTorch
    ``(out, in)`` weights, fused QKV): in every ``attention`` block the
    QKV weight and bias shard their output dim (a third of each of the
    query, key and value rows a part: whole heads), the ``out`` weight
    its input dim; in every ``ffn`` block the ``intermediate`` weight and
    bias their output dim, the ``output`` weight its input dim.  The
    output biases and LayerNorms, and everything else, stay whole.  The
    TVC decoder stays whole too: its KV-cached decode runs every head.
    (The JAX rule matches any path holding ``query``, which shards the
    VSM head's query projections as well; GSPMD reassembles them, and the
    port keeps them whole.)"""
    def spec(path) -> Optional[Shard]:
        if "decoder" in path or len(path) < 3:
            return None
        block, lin, kind = path[-3], path[-2], path[-1]
        if block == "attention":
            if lin == "qkv":
                return Shard(0, 3)
            if lin == "out" and kind == "weight":
                return Shard(1)
        if block == "ffn":
            if lin == "intermediate":
                return Shard(0)
            if lin == "output" and kind == "weight":
                return Shard(1)
        return None
    return [spec(p) for p in optim.tree_paths(params)]
