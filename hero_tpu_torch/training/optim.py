"""AdamW with HERO's 4-group policy, plus LR schedules (counterpart of
``hero_tpu/training/optim.py``).

- HF-style decoupled AdamW: eps added to sqrt(v), bias correction on, and
  weight decay applied to the ALREADY-UPDATED value with the leaf's lr
  (reference ``optim/adamw.py:104``);
- 4 parameter groups, (top vs backbone) x (decay vs no-decay), expressed as
  per-leaf masks over the port's parameter tree: "top" is every parameter
  outside ``v_encoder`` (it gets ``lr_mul * lr``), "no-decay" every
  ``bias`` and every parameter of a LayerNorm (a dict whose key ends in
  ``ln``);
- ``warmup_linear``, ``noam`` and ``vqa`` schedules, with the 1e-8 floor.

The schedule runs on the host from the step counter (a Python int), so the
learning rate is a Python float.  Updates are out of place: they return new
tensors and leave the inputs as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch

Params = Any


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def warmup_linear(step: int, warmup_step: int, tot_step: int) -> float:
    """BERT schedule (reference sched.py:20-24)."""
    if step < warmup_step:
        return step / max(warmup_step, 1)
    return max(0.0, (tot_step - step) / max(tot_step - warmup_step, 1))


def noam_schedule(step: int, warmup_step: int = 4000) -> float:
    if step <= warmup_step:
        return step / warmup_step
    return (warmup_step ** 0.5) * max(step, 1.0) ** -0.5


def vqa_schedule(step: int, warmup_interval: int, decay_interval: int,
                 decay_start: int, decay_rate: float) -> float:
    """MCAN-style VQA step schedule (reference sched.py:27-40)."""
    if step < warmup_interval:
        return 0.25
    if step < 2 * warmup_interval:
        return 0.5
    if step < 3 * warmup_interval:
        return 0.75
    if step >= decay_start:
        return decay_rate ** math.ceil((step - decay_start) / decay_interval)
    return 1.0


def get_lr(step: int, learning_rate: float, warmup_steps: int,
           num_train_steps: int, schedule: str = "warmup_linear") -> float:
    """reference get_lr_sched (sched.py:43-49) with its 1e-8 floor;
    schedule in {warmup_linear, noam, vqa}."""
    if schedule == "noam":
        mult = noam_schedule(step, warmup_steps)
    elif schedule == "vqa":
        mult = vqa_schedule(step, warmup_steps, warmup_steps,
                            num_train_steps // 2, 0.5)
    else:
        mult = warmup_linear(step, warmup_steps, num_train_steps)
    return max(learning_rate * mult, 1e-8)


# ---------------------------------------------------------------------------
# trees and masks
# ---------------------------------------------------------------------------

def tree_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Key paths of the tensor leaves (list indices as strings), in the
    order :func:`tree_leaves` gives the leaves."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, prefix
                                                                + (str(k),))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, prefix + (str(i),))]
    return [prefix]


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree, *rest):
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


def decays(path: Tuple[str, ...]) -> bool:
    """False for biases and LayerNorm parameters (no weight decay)."""
    if path[-1] == "bias":
        return False
    return not (len(path) >= 2 and path[-2].endswith("ln"))


def is_top(path: Tuple[str, ...]) -> bool:
    """True for parameters outside ``v_encoder`` (the task heads)."""
    return path[0] != "v_encoder"


def no_decay_mask(params) -> Params:
    """1.0 where weight decay applies, 0.0 for biases and LN params."""
    return tree_unflatten(params, [float(decays(p))
                                   for p in tree_paths(params)])


def top_lr_mask(params) -> Params:
    """1.0 for params outside v_encoder (the heads), else 0.0."""
    return tree_unflatten(params, [float(is_top(p))
                                   for p in tree_paths(params)])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamWState:
    step: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    weight_decay: float = 0.01
    correct_bias: bool = True
    lr_mul: float = 1.0


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, lr: float,
                 cfg: AdamWConfig) -> Tuple[Params, AdamWState]:
    """One AdamW step: (new params, new state)."""
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    sf = (math.sqrt(1.0 - b2 ** step) / (1.0 - b1 ** step)
          if cfg.correct_bias else 1.0)
    out_p, out_m, out_v = [], [], []
    for path, g, m, v, p in zip(tree_paths(params), tree_leaves(grads),
                                tree_leaves(state.mu), tree_leaves(state.nu),
                                tree_leaves(params)):
        g = g.float()
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        leaf_lr = lr * (cfg.lr_mul if is_top(path) else 1.0)
        p_new = p.float() - (leaf_lr * sf) * m / (v.sqrt() + cfg.eps)
        if decays(path):
            p_new = p_new - (leaf_lr * cfg.weight_decay) * p_new
        out_p.append(p_new.to(p.dtype))
        out_m.append(m)
        out_v.append(v)
    return (tree_unflatten(params, out_p),
            AdamWState(step=step, mu=tree_unflatten(params, out_m),
                       nu=tree_unflatten(params, out_v)))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(g.float().square().sum()
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics: (clipped grads, norm).
    The scale stays on the device: no host synchronisation."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm
