"""The train step on one device (counterpart of
``hero_tpu/training/step.py``): forward, backward, gradient accumulation
over micro-batches, the LR schedule, global-norm clipping and AdamW.

``loss_fn(params, batch, seed) -> (loss, aux)`` returns a 0-d loss tensor
and a dict of 0-d tensors; ``seed`` is the step's integer seed (None turns
dropout off).  The step differentiates the loss with respect to every
parameter leaf with ``torch.autograd.grad``; the state's tensors are never
marked as requiring grad themselves.  Sharding and ZeRO wait for ROADMAP
A8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from hero_tpu_torch.models import nn
from hero_tpu_torch.training import optim as optim_lib
from hero_tpu_torch.training.optim import AdamWConfig, AdamWState


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    global_step: int                # optimizer steps taken

    @classmethod
    def create(cls, params) -> "TrainState":
        return cls(params=params, opt=optim_lib.adamw_init(params),
                   global_step=0)


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Static training hyper-parameters (reference opts subset)."""
    learning_rate: float = 3e-5
    warmup_steps: int = 1000
    num_train_steps: int = 100000
    grad_norm: float = 2.0          # -1 disables clipping
    adamw: AdamWConfig = AdamWConfig()
    lr_schedule: str = "warmup_linear"   # | "noam" | "vqa"


def loss_and_grads(loss_fn: Callable, params, batch, seed: Optional[int]):
    """(loss, aux, grads) of one micro-batch; grads have the params' tree
    and are zero for a parameter the loss does not reach."""
    leaves = [p.detach().requires_grad_(True)
              for p in optim_lib.tree_leaves(params)]
    loss, aux = loss_fn(optim_lib.tree_unflatten(params, leaves), batch,
                        seed)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            optim_lib.tree_unflatten(params, grads))


def make_train_step(loss_fn: Callable, spec: TrainSpec, *,
                    accum_steps: int = 1):
    """``step(state, batch, seed) -> (new_state, metrics)``.

    With ``accum_steps > 1`` every batch entry has a leading micro-batch
    axis; grads, loss and aux are averaged over the micro-batches, and
    micro-batch i draws its dropout from the sub-seed ``micro{i}``.
    ``metrics`` holds 0-d tensors (loss, grad_norm, aux) and the float lr;
    reading them is the caller's synchronisation point."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             seed: Optional[int] = None) -> Tuple[TrainState, Dict]:
        if accum_steps > 1:
            grads = aux = None
            loss = 0.0
            for i in range(accum_steps):
                micro = {k: v[i] for k, v in batch.items()}
                l_i, a_i, g_i = loss_and_grads(
                    loss_fn, state.params, micro, nn.rng_for(seed,
                                                             f"micro{i}"))
                loss = loss + l_i
                grads = g_i if grads is None else optim_lib.tree_map(
                    torch.add, grads, g_i)
                aux = a_i if aux is None else {k: aux[k] + a_i[k]
                                               for k in aux}
            grads = optim_lib.tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            aux = {k: v / accum_steps for k, v in aux.items()}
        else:
            loss, aux, grads = loss_and_grads(loss_fn, state.params, batch,
                                              seed)
        new_step = state.global_step + 1
        lr = optim_lib.get_lr(new_step, spec.learning_rate,
                              spec.warmup_steps, spec.num_train_steps,
                              schedule=spec.lr_schedule)
        if spec.grad_norm > 0:
            grads, gnorm = optim_lib.clip_by_global_norm(grads,
                                                         spec.grad_norm)
        else:
            gnorm = optim_lib.global_norm(grads)
        new_params, new_opt = optim_lib.adamw_update(
            grads, state.opt, state.params, lr, spec.adamw)
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, **aux}
        return TrainState(params=new_params, opt=new_opt,
                          global_step=new_step), metrics

    return step
