"""Pipeline parallelism over the grid's stage ranks: GPipe (counterpart of
``hero_tpu/parallel/pipeline.py``).

One process a stage.  Stage s of S holds layers [s L/S, (s+1) L/S) of
every encoder stack whose depth S divides (and is at least S); the other
stages' places in its ``layers`` list are None (:func:`stage_params`), so
a stage never holds another stage's weights and a stage-sharded stack has
no sequential fallback.  Decoder stacks, and stacks S does not divide
(the 3-layer c-encoder at S = 2), stay whole and sequential on every
stage.

:func:`pipelined_encoder` splits the call's rows into M micro-batches
(the largest divisor of the rows at most ``--pp_microbatches``, as
``pipeline.py:170-176`` does) and runs the GPipe schedule: stage s takes
micro-batch j from stage s - 1 (stage 0 from the input), runs its layers
and hands the result to stage s + 1; the last stage's outputs are
broadcast to the stage group, so every stage goes on with the same
replicated computation (the JAX ``psum`` at ``:220``).  The backward
runs the other way: d(out) enters at the last stage, each stage
differentiates its micro-batches' graphs and hands d(input) down, and
stage 0's d(x) is broadcast to the stage group, so every stage's
replicated leaves get the same gradient.  Micro-batch j's layer i draws
its dropout from the sub-seed ``micro{j}`` of the layer's (``:184``
folds j into the layer key).

The stage-to-stage transfer is a broadcast in the 2-rank group of the
two stages (``dist.Grid.pair_groups``), on every backend: gloo takes
CUDA tensors in a broadcast (through the host), while its ``send`` of a
CUDA tensor aborted the sending process on an H100 (PyTorch 2.11;
PERF.md).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as tdist
from torch.utils.checkpoint import checkpoint

from hero_tpu_torch.models import nn
from hero_tpu_torch.parallel import dist
from hero_tpu_torch.training import optim

_PP = {"enabled": False, "n_micro": 2}


def enable_pipeline(enabled: bool, n_microbatches: int = 2) -> None:
    """Turn the pipeline over the grid's stage ranks on (or off) for the
    encoder calls that follow (``pipeline.py:68-76``)."""
    if n_microbatches < 1:
        raise ValueError(f"--pp_microbatches {n_microbatches}: at least 1")
    if enabled and dist.grid().axis != "stage":
        raise ValueError("the pipeline needs a stage grid "
                         f"(dist.init_grid('stage', S)); the grid is "
                         f"{dist.grid().axis!r}")
    _PP.update(enabled=bool(enabled), n_micro=int(n_microbatches))


def n_stages() -> int:
    g = dist.grid()
    return g.inner_world if _PP["enabled"] and g.axis == "stage" else 1


def active(n_layers: int) -> bool:
    """True when a pipeline is on and an ``n_layers`` stack splits evenly
    over its stages (``pipeline.py:79-90``)."""
    s = n_stages()
    return s > 1 and n_layers >= s and n_layers % s == 0


def _per_stage(path: Tuple[str, ...], layers: list, n_stage: int) -> int:
    """The layers a stage holds of the list ``layers`` at ``path``: 0
    unless it is an encoder stack (the tree's own ``layers``, or one under
    an ``encoder`` key, never a decoder's: ``pipeline.py:101-127``) whose
    depth ``n_stage`` divides and is at least ``n_stage``."""
    anchored = (bool(path) and path[-1] == "layers"
                and (len(path) == 1 or path[-2] == "encoder")
                and "decoder" not in path)
    if anchored and 1 < n_stage <= len(layers) and len(layers) % n_stage == 0:
        return len(layers) // n_stage
    return 0


def pp_param_spec(params, n_stage: int) -> List[Optional[int]]:
    """The stage that holds each leaf (``training/optim.tree_leaves``
    order) of a full tree: the owner of its layer for a leaf of a
    pipelined stack, None (every stage) for every other leaf."""
    out: List[Optional[int]] = []

    def walk(t, path, owner):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,), owner)
        elif isinstance(t, list):
            per = _per_stage(path, t, n_stage)
            for i, v in enumerate(t):
                walk(v, path + (str(i),), i // per if per else owner)
        elif t is not None:
            out.append(owner)

    walk(params, (), None)
    return out


def stage_params(params, stage: int, n_stage: int):
    """``params`` as stage ``stage`` holds them: another stage's layers of
    a pipelined stack replaced by None."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            per = _per_stage(path, t, n_stage)
            return [None if per and i // per != stage
                    else walk(v, path + (str(i),))
                    for i, v in enumerate(t)]
        return t
    return walk(params, ())


def stage_sharded(params) -> List[bool]:
    """Per leaf of a stage's tree: whether it is one of this stage's
    layers of a pipelined stack (its list holds None)."""
    out: List[bool] = []

    def walk(t, inside):
        if isinstance(t, dict):
            for v in t.values():
                walk(v, inside)
        elif isinstance(t, list):
            inner = inside or any(v is None for v in t)
            for v in t:
                walk(v, inner)
        elif t is not None:
            out.append(inside)

    walk(params, False)
    return out


def driver_grid(opts, global_batch: int) -> dist.Grid:
    """The grid of a training program (``pipeline.py:130-149``): with
    ``--pp_stages`` S > 1 the world splits into (data = W/S, stage = S)
    and the pipeline turns on with ``--pp_microbatches`` M; otherwise the
    plain data-parallel world.  Refuses what the JAX package refuses:
    ``--zero1`` with S > 1, an S that does not divide the world, a global
    batch the data ranks do not divide, and an M that does not divide a
    data rank's batch."""
    s = int(getattr(opts, "pp_stages", 1) or 1)
    if s <= 1:
        enable_pipeline(False)
        return dist.init_grid()
    if getattr(opts, "zero1", False):
        raise ValueError(f"--zero1 with --pp_stages {s}: ZeRO-1 shards the "
                         "moments over the plain data-parallel world, not "
                         "over data x stage ranks")
    world = dist.world_size()
    if world % s:
        raise ValueError(
            f"--pp_stages {s} on {world} rank{'s' if world > 1 else ''}: "
            f"one rank a stage, so the world must be a multiple of {s} "
            f"(one rank cannot hold {s} stages)")
    n_data = world // s
    if global_batch % n_data:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"over {n_data} data ranks")
    m = int(getattr(opts, "pp_microbatches", 2) or 2)
    if (global_batch // n_data) % m:
        raise ValueError(
            f"--pp_microbatches {m} does not divide a data rank's batch of "
            f"{global_batch // n_data}")
    grid = dist.init_grid("stage", s)
    enable_pipeline(True, m)
    return grid


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _raw(t: torch.Tensor) -> torch.Tensor:
    # 2-byte elements travel as their bytes: gloo has no 16-bit types
    return t.view(torch.uint8) if t.element_size() == 2 else t


def _transfer(t: torch.Tensor, src_stage: int, dst_stage: int) -> None:
    """``t`` from stage ``src_stage`` to its neighbour ``dst_stage``, in
    place on the receiver: a broadcast in the two stages' group.  The
    source's ``t`` is written too (gloo copies a CUDA tensor through the
    host and back), so it must be no tensor an autograd graph saved."""
    g = dist.grid()
    lo = min(src_stage, dst_stage)
    if g.inner_rank == src_stage:
        dist.count_bytes(t)
    tdist.broadcast(_raw(t), src=g.inner_ranks[src_stage],
                    group=g.pair_groups[lo])


def _broadcast_from(t: torch.Tensor, stage: int) -> torch.Tensor:
    """``t`` of stage ``stage`` on every stage of the group, in place."""
    g = dist.grid()
    if g.inner_rank == stage:
        dist.count_bytes(t)
    tdist.broadcast(_raw(t), src=g.inner_ranks[stage], group=g.inner_group)
    return t


def _micro_rows(n: int) -> List[Tuple[int, int]]:
    """(start, stop) of each micro-batch of ``n`` rows: M the largest
    divisor of ``n`` at most the requested count."""
    m = _PP["n_micro"]
    while n % m:
        m -= 1
    k = n // m
    return [(j * k, (j + 1) * k) for j in range(m)]


class _Run:
    """One pipelined call: this stage's layers (from index ``lo``), the
    call's masks and options."""

    def __init__(self, own, lo, cfg, mask_kw, train, seed, dtype, remat,
                 layer_fn):
        self.own, self.lo, self.cfg = own, lo, cfg
        self.mask_kw, self.train, self.seed = mask_kw, train, seed
        self.dtype, self.remat, self.layer_fn = dtype, remat, layer_fn

    def block(self, layers, h, rows, j):
        a, b = rows
        kw = {k: v[a:b] for k, v in self.mask_kw.items()}
        for k, layer in enumerate(layers):
            seed = nn.rng_for(nn.rng_for(self.seed, f"layer{self.lo + k}"),
                              f"micro{j}")
            if self.remat:
                h = checkpoint(self.layer_fn, layer, h, self.cfg,
                               use_reentrant=False, preserve_rng_state=False,
                               train=self.train, seed=seed,
                               dtype=self.dtype, **kw)
            else:
                h = self.layer_fn(layer, h, self.cfg, train=self.train,
                                  seed=seed, dtype=self.dtype, **kw)
        return h

    def forward(self, x, layers, keep_graph: bool):
        """The forward schedule; with ``keep_graph`` each micro-batch's
        (input, output) with its autograd graph, for the backward."""
        g = dist.grid()
        s, S = g.inner_rank, g.inner_world
        micro = _micro_rows(x.shape[0])
        outs, saved = [], []
        for j, rows in enumerate(micro):
            a, b = rows
            if s == 0:
                h_in = x[a:b].detach()
            else:
                h_in = torch.empty((b - a,) + tuple(x.shape[1:]),
                                   dtype=x.dtype, device=x.device)
                _transfer(h_in, s - 1, s)
            if keep_graph:
                h_in.requires_grad_(True)
                with torch.enable_grad():
                    h = self.block(layers, h_in, rows, j)
                saved.append((h_in, h))
            else:
                h = self.block(layers, h_in, rows, j)
            if h.dtype != x.dtype or h.shape != h_in.shape:
                raise RuntimeError(
                    f"a pipelined stage changed its rows from {x.dtype} "
                    f"{tuple(h_in.shape)} to {h.dtype} {tuple(h.shape)}")
            h = h.detach()
            if s < S - 1:
                # a copy: gloo's broadcast of a CUDA tensor writes it back
                # at its source too, which would bump the version of the
                # graph's output
                _transfer(h.clone(memory_format=torch.contiguous_format),
                          s, s + 1)
            else:
                outs.append(h)
        out = (torch.cat(outs, 0) if s == S - 1 else
               torch.empty_like(x))
        return _broadcast_from(out, S - 1), saved, micro

    def backward(self, saved, micro, d_out, leaves):
        g = dist.grid()
        s, S = g.inner_rank, g.inner_world
        totals: List[Optional[torch.Tensor]] = [None] * len(leaves)
        d_in = []
        for j, ((a, b), (h_in, h)) in enumerate(zip(micro, saved)):
            if s == S - 1:
                gj = d_out[a:b].contiguous()
            else:
                gj = torch.empty_like(h)
                _transfer(gj, s + 1, s)
            grads = torch.autograd.grad(h, [h_in] + leaves, gj,
                                        allow_unused=True)
            for k, gk in enumerate(grads[1:]):
                if gk is not None:
                    totals[k] = gk if totals[k] is None else totals[k] + gk
            dh = grads[0].contiguous()
            if s > 0:
                _transfer(dh, s, s - 1)
            else:
                d_in.append(dh)
        dx = (torch.cat(d_in, 0) if s == 0 else torch.empty_like(d_out))
        _broadcast_from(dx, 0)
        return dx, [torch.zeros_like(t) if gt is None else gt
                    for t, gt in zip(leaves, totals)]


class _Pipelined(torch.autograd.Function):

    @staticmethod
    def forward(ctx, run, x, *leaves):
        grads = [t.detach().requires_grad_(True) for t in leaves]
        layers = optim.tree_unflatten(run.own, grads)
        out, saved, micro = run.forward(x, layers, keep_graph=True)
        ctx.run, ctx.saved, ctx.micro, ctx.grads = run, saved, micro, grads
        return out

    @staticmethod
    def backward(ctx, d_out):
        dx, dl = ctx.run.backward(ctx.saved, ctx.micro, d_out.contiguous(),
                                  ctx.grads)
        ctx.saved = None
        return (None, dx, *dl)


def pipelined_encoder(layers: list, x: torch.Tensor, cfg, *, kv_mask=None,
                      seg=None, train: bool = False,
                      seed: Optional[int] = None,
                      dtype: torch.dtype = torch.float32,
                      remat: bool = False, layer_fn=None) -> torch.Tensor:
    """A stage-sharded encoder stack (``layers``: this stage's layers,
    None for the others') over the active stage group
    (``pipeline.py:152-234``); the same result on every stage.  Equal to
    the sequential stack with dropout off (the same layer order; the
    transfers add no arithmetic)."""
    if not active(len(layers)):
        raise RuntimeError(
            f"a stack of {len(layers)} layers sharded over stages, but the "
            f"pipeline is not on over a stage group that divides it "
            f"({n_stages()} stages)")
    held = [i for i, l in enumerate(layers) if l is not None]
    own = [layers[i] for i in held]
    mask_kw = {k: v for k, v in (("kv_mask", kv_mask), ("seg", seg))
               if v is not None}
    run = _Run(own, held[0], cfg, mask_kw, train, seed, dtype,
               remat and train, layer_fn)
    leaves = optim.tree_leaves(own)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in leaves)):
        return _Pipelined.apply(run, x, *leaves)
    return run.forward(x, own, keep_graph=False)[0]
