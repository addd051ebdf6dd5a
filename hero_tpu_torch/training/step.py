"""The train step (counterpart of ``hero_tpu/training/step.py``): forward,
backward, gradient accumulation over micro-batches, the LR schedule,
global-norm clipping and AdamW, on one device or as one rank of a
data-parallel world (``parallel/dist``).

``loss_fn(params, batch, seed) -> (loss, aux)`` returns a 0-d loss tensor
and a dict of 0-d tensors; ``seed`` is the step's integer seed (None turns
dropout off).  The step differentiates the loss with respect to every
parameter leaf with ``torch.autograd.grad``; the state's tensors are never
marked as requiring grad themselves.  A leaf the loss does not reach (a
pooler, a task head another loss reads) gets no gradient tensor: its
gradient is None, which clipping, the all-reduce and AdamW take as an
exact zero, so AdamW moves it as the JAX package's does.  On W ranks
each rank holds the whole state and 1/W of the global batch's rows; the
loss is the rank's share of the global batch's (``dist.data_parallel``),
and the summed gradients are the global loss's.

On a grid (``parallel/dist.init_grid``) the state is this rank's
(:func:`shard_state` cuts a whole one; :func:`gather_state` puts the
whole one back together, for the files): a pipeline stage holds its
layers (``parallel/pipeline``), a model rank its tensor-parallel parts
(``parallel/mesh.tp_param_spec``), a seq rank the whole tree.  The step
sums the gradients over the data group only, and clips by the global
norm, which counts each stage's layers and each model rank's parts once
(their squares summed over the inner group) and each replicated leaf
once.  With ``zero1`` on several data ranks of a plain world (ZeRO-1,
``hero_tpu/training/step.py:118-175``) each rank holds its
``parallel/mesh.zero1_opt_spec`` slice of every sharded leaf's AdamW
moments: the step clips as the replicated step does, runs AdamW on the
rank's slices and all-gathers the parameters, equal to the replicated
step bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from hero_tpu_torch.models import nn
from hero_tpu_torch.parallel import dist, mesh, pipeline
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


def leaf_grads(loss_fn: Callable, params, batch, seed: Optional[int]):
    """(loss, aux, grads) of one micro-batch; grads is the list of the
    params' leaves' gradients (``optim.tree_leaves`` order), None for a
    leaf the loss does not reach: a zero gradient, as ``jax.grad`` gives
    it, with no tensor made for it (``optim.adamw_update``)."""
    leaves = [p.detach().requires_grad_(True)
              for p in optim_lib.tree_leaves(params)]
    loss, aux = loss_fn(optim_lib.tree_unflatten(params, leaves), batch,
                        seed)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def loss_and_grads(loss_fn: Callable, params, batch, seed: Optional[int]):
    """(loss, aux, grads) of one micro-batch; grads have the params' tree
    and are zero for a parameter the loss does not reach, as
    ``jax.grad`` gives them: the form the parity checks compare.  The
    train step and the optimizer take :func:`leaf_grads`' list."""
    loss, aux, grads = leaf_grads(loss_fn, params, batch, seed)
    return loss, aux, optim_lib.tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(optim_lib.tree_leaves(params), grads)])


def _zero1_on(zero1: bool) -> bool:
    """Whether ZeRO-1 shards the moments on this grid; raises where the
    JAX package refuses it (``hero_tpu/training/step.py:136-139``)."""
    if not zero1:
        return False
    axis = dist.inner_axis()
    if axis is not None:
        raise ValueError(f"--zero1 on a {axis} grid: ZeRO-1 shards the "
                         "moments over the plain data-parallel world only")
    return dist.data_world() > 1


def _inner_sharded(params) -> Optional[list]:
    """Per leaf of this rank's tree: whether it is this inner rank's own
    (a stage's layers, a model rank's parts); None where no leaf is."""
    axis = dist.inner_axis()
    if axis == "model":
        return [sh is not None for sh in mesh.tp_param_spec(params)]
    if axis == "stage":
        return pipeline.stage_sharded(params)
    return None


def _cut(leaves, specs, r: int, n: int):
    return [t if sh is None else mesh.split(t, sh, r, n)
            for t, sh in zip(leaves, specs)]


def _joined(leaves, specs, group):
    """``leaves`` with every sharded one (``specs``) gathered whole over
    ``group`` (one flat all-gather)."""
    mine = [t for t, sh in zip(leaves, specs) if sh is not None]
    if not mine:
        return list(leaves)
    parts = iter(zip(*dist.all_gather_flat(mine, group)))
    return [t if sh is None else mesh.join(next(parts), sh)
            for t, sh in zip(leaves, specs)]


def _tp_specs(params):
    """The tensor-parallel specs of ``params``, checked to divide over
    the model ranks."""
    n = dist.inner_world()
    specs = mesh.tp_param_spec(params)
    for t, sh in zip(optim_lib.tree_leaves(params), specs):
        if sh is not None and (t.shape[sh.dim] // sh.blocks) % n:
            raise ValueError(f"a leaf of shape {tuple(t.shape)} does not "
                             f"split over {n} model ranks")
    return specs


def shard_state(state: TrainState, zero1: bool = False) -> TrainState:
    """This rank's part of a whole ``state`` on the grid
    (``hero_tpu/training/step.py:128-175``): a stage's layers, a model
    rank's tensor-parallel parts (moments as their leaves), with
    ``zero1`` on several data ranks the rank's moment slices; the state
    itself on a plain grid without ZeRO-1."""
    g = dist.grid()
    trees = [state.params, state.opt.mu, state.opt.nu]
    axis = dist.inner_axis()
    if axis == "model":
        specs = _tp_specs(state.params)
        trees = [optim_lib.tree_unflatten(t, _cut(
            optim_lib.tree_leaves(t), specs, g.inner_rank, g.inner_world))
            for t in trees]
    elif axis == "stage":
        trees = [pipeline.stage_params(t, g.inner_rank, g.inner_world)
                 for t in trees]
    if _zero1_on(zero1):
        specs = mesh.zero1_opt_spec(state.params, g.data_world)
        trees[1:] = [optim_lib.tree_unflatten(t, _cut(
            optim_lib.tree_leaves(t), specs, g.data_rank, g.data_world))
            for t in trees[1:]]
    params, mu, nu = trees
    return TrainState(params=params,
                      opt=AdamWState(step=state.opt.step, mu=mu, nu=nu),
                      global_step=state.global_step)


def _gather_stages(tree, group):
    """A stage's tree with every stage's layers in place of its Nones:
    each stage holds as many layers of each pipelined stack, of the same
    shapes, so one flat all-gather carries them."""
    stacks = []

    def find(t):
        if isinstance(t, dict):
            for v in t.values():
                find(v)
        elif isinstance(t, list):
            if any(v is None for v in t):
                stacks.append(t)
            else:
                for v in t:
                    find(v)
    find(tree)
    if not stacks:
        return tree
    own = [[v for v in st if v is not None] for st in stacks]
    by_stage = [optim_lib.tree_unflatten(own, part) for part in
                dist.all_gather_flat(optim_lib.tree_leaves(own), group)]
    whole = {id(st): [by_stage[i // len(o)][k][i % len(o)]
                      for i in range(len(st))]
             for k, (st, o) in enumerate(zip(stacks, own))}

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return whole[id(t)] if id(t) in whole else [build(v) for v in t]
        return t
    return build(tree)


def gather_params(tree):
    """A tree of this rank's parameter layout (the parameters, their
    gradients or moments) whole on every rank: another stage's layers,
    the other model ranks' parts.  A collective every rank of the inner
    group calls; ``tree`` itself on a data or seq grid."""
    g = dist.grid()
    axis = dist.inner_axis()
    if axis == "model":
        return optim_lib.tree_unflatten(tree, _joined(
            optim_lib.tree_leaves(tree), mesh.tp_param_spec(tree),
            g.inner_group))
    if axis == "stage":
        return _gather_stages(tree, g.inner_group)
    return tree


def gather_state(state: TrainState, zero1: bool = False) -> TrainState:
    """The whole train state from this rank's (the inverse of
    :func:`shard_state`), on every rank: a collective every rank calls.
    The state itself on a plain grid without ZeRO-1."""
    g = dist.grid()
    mu, nu = state.opt.mu, state.opt.nu
    if _zero1_on(zero1):
        specs = mesh.zero1_opt_spec(state.params, g.data_world)
        mu, nu = (optim_lib.tree_unflatten(t, _joined(
            optim_lib.tree_leaves(t), specs, g.data_group))
            for t in (mu, nu))
    params, mu, nu = (gather_params(t) for t in (state.params, mu, nu))
    if params is state.params and mu is state.opt.mu:
        return state
    return TrainState(params=params,
                      opt=AdamWState(step=state.opt.step, mu=mu, nu=nu),
                      global_step=state.global_step)


def _global_norm(grads, sharded) -> torch.Tensor:
    """The global norm of a leaf list whose ``sharded`` leaves are this
    inner rank's own: their squares summed over the inner group, the
    replicated leaves' counted once; a None leaf adds nothing."""
    zero = torch.zeros((), dtype=torch.float32,
                       device=next(g for g in grads if g is not None).device)
    rep = sum((g.float().square().sum() for g, s in zip(grads, sharded)
               if g is not None and not s), zero)
    own = sum((g.float().square().sum() for g, s in zip(grads, sharded)
               if g is not None and s), zero)
    own = dist.all_reduce_cast(own, dist.grid().inner_group)
    return torch.sqrt(rep + own)


def _zero1_adamw(grads, state: TrainState, lr: float, cfg: AdamWConfig,
                 specs):
    """AdamW on this data rank's slices (views of the parameters and of
    the gradient list; its moments are slices already): (the new slices,
    the new AdamW state)."""
    g = dist.grid()

    def mine(t, sh):
        return (t if sh is None or t is None
                else t.chunk(g.data_world, sh.dim)[g.data_rank])
    params = optim_lib.tree_unflatten(state.params, [
        mine(t, sh) for t, sh in zip(optim_lib.tree_leaves(state.params),
                                     specs)])
    return optim_lib.adamw_update(
        [mine(t, sh) for t, sh in zip(grads, specs)], state.opt, params, lr,
        cfg)


def make_train_step(loss_fn: Callable, spec: TrainSpec, *,
                    accum_steps: int = 1, group=None, zero1: bool = False):
    """``step(state, batch, seed) -> (new_state, metrics)``
    (``hero_tpu/training/step.py:177-214``).

    With ``accum_steps > 1`` every batch entry has a leading micro-batch
    axis; grads, loss and aux are averaged over the micro-batches, and
    micro-batch i draws its dropout from the sub-seed ``micro{i}``.

    ``group`` is the data-parallel process group (default: the world
    when it has several ranks, else none; ``dist.ALONE``: this process
    on its batch alone).  On W > 1 ranks ``batch`` is
    the rank's rows (``dist.shard_rows``); the forward and backward run
    under ``dist.data_parallel`` (global-batch losses, the rank folded
    into the dropout seeds), and the gradients, loss and aux are summed
    over the ranks in one flat buffer before clipping, so every rank
    clips by the global norm and takes the same AdamW step.

    ``metrics`` holds 0-d tensors (loss, grad_norm, aux: the global
    batch's) and the float lr; reading them is the caller's
    synchronisation point.

    On a grid the state is this rank's (:func:`shard_state`); ``zero1``
    shards the moments over several data ranks of a plain world, and
    raises on a stage, model or seq grid."""
    sharded_moments = _zero1_on(zero1) and group is not dist.ALONE

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             seed: Optional[int] = None) -> Tuple[TrainState, Dict]:
        grp = (dist.data_group() if group is None
               else None if group is dist.ALONE else group)
        with dist.data_parallel(grp):
            loss, aux, grads = _grads(state, batch, seed)
        if grp is not None:
            keys = sorted(aux)
            summed = dist.all_reduce_flat(
                grads + [loss] + [aux[k] for k in keys], grp,
                like=optim_lib.tree_leaves(state.params))
            n = len(grads)
            grads, loss = summed[:n], summed[n]
            aux = dict(zip(keys, summed[n + 1:]))
        new_step = state.global_step + 1
        lr = optim_lib.get_lr(new_step, spec.learning_rate,
                              spec.warmup_steps, spec.num_train_steps,
                              schedule=spec.lr_schedule)
        sharded = (None if group is dist.ALONE
                   else _inner_sharded(state.params))
        norm = None if sharded is None else _global_norm(grads, sharded)
        if spec.grad_norm > 0:
            grads, gnorm = optim_lib.clip_by_global_norm(
                grads, spec.grad_norm, norm)
        else:
            gnorm = optim_lib.global_norm(grads) if norm is None else norm
        if sharded_moments:
            specs = mesh.zero1_opt_spec(state.params, dist.data_world())
            mine, new_opt = _zero1_adamw(grads, state, lr, spec.adamw,
                                         specs)
            del grads        # freed before the all-gather of the parameters
            new_params = optim_lib.tree_unflatten(mine, _joined(
                optim_lib.tree_leaves(mine), specs, dist.data_group()))
            del mine
        else:
            new_params, new_opt = optim_lib.adamw_update(
                grads, state.opt, state.params, lr, spec.adamw)
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, **aux}
        return TrainState(params=new_params, opt=new_opt,
                          global_step=new_step), metrics

    def _grads(state, batch, seed):
        """(loss, aux, gradient leaf list) of the step's batch, averaged
        over its micro-batches."""
        if accum_steps > 1:
            grads = aux = None
            loss = 0.0
            for i in range(accum_steps):
                micro = {k: v[i] for k, v in batch.items()}
                l_i, a_i, g_i = leaf_grads(
                    loss_fn, state.params, micro, nn.rng_for(seed,
                                                             f"micro{i}"))
                loss = loss + l_i
                grads = g_i if grads is None else [
                    b if a is None else a if b is None else a + b
                    for a, b in zip(grads, g_i)]
                aux = a_i if aux is None else {k: aux[k] + a_i[k]
                                               for k in aux}
            grads = [None if g is None else g / accum_steps for g in grads]
            loss = loss / accum_steps
            aux = {k: v / accum_steps for k, v in aux.items()}
            return loss, aux, grads
        return leaf_grads(loss_fn, state.params, batch, seed)

    return step
