"""Data parallelism over ``torch.distributed``: the process side of
``hero_tpu/parallel/mesh.py``.

One process a rank.  Every rank holds a full replica of the parameters
and the AdamW state, builds the identical global batch stream on the
host, and works on its contiguous 1/W of each global batch's rows
(:func:`shard_rows`).  Where the JAX package lets GSPMD insert the
collectives, the port calls them itself:

- the gradient all-reduce: :func:`all_reduce_grads`, one flat fp32
  buffer summed, before clipping (``training/step.make_train_step``);
- a global-batch loss (:func:`data_parallel`, set by the train step)
  takes one of two rules.  (a) A per-item term ``s / max(n, 1)`` divides
  the rank's own sum by the all-reduced count (:func:`global_mean`).
  (b) A cross-batch term (the VSM ranking losses, MFM-NCE) is computed
  from :func:`gather_rows` of its inputs, identically on every rank; the
  gather's backward returns the rank's own slice, so the summed parameter
  gradients are the global term's.  :func:`replicated` makes such a term
  the rank's share of its value, so that every loss and metric a rank
  returns sums over the ranks to the global value;
- dropout draws fold the rank into their seeds (:func:`fold_rank`);
- the pickled-object gather of the serving paths: :func:`host_allgather`.

A process that never called :func:`init_distributed` is a world of 1,
where every helper is the identity and nothing is communicated.

Backends: ``nccl`` with one card a rank; ``gloo`` on the CPU and where
ranks share one card.  gloo takes CUDA tensors in every collective used
here (all-reduce, all-gather, the object gather; PyTorch 2.11 on an
H100), copying them through the host itself, so the helpers hand every
backend the tensors where they lie.  16-bit tensors travel as their
bytes: gloo has no 16-bit types.

A grid (:func:`init_grid`; the process half of ``get_pp_mesh`` /
``get_2d_mesh`` / ``get_seq_mesh``, ``hero_tpu/parallel/mesh.py:194-241``)
splits the W ranks as (data = W/S, inner = S) for an inner axis
``stage`` (pipeline stages), ``model`` (tensor parallelism) or ``seq``
(sequence parallelism): global rank g is data rank g // S and inner rank
g % S.  The ranks of one inner group see the same rows; rows, queries
and video batches split over the data ranks (:func:`data_rank`,
:func:`data_world`), the train step reduces over the data group, and
dropout folds the data rank.  A plain world is the grid (W, 1).  The
inner axes' autograd pieces live here too: Megatron's pair
(:func:`copy_to_inner`, :func:`reduce_from_inner`), the frame slice and
gathers of sequence parallelism (:func:`seq_slice`, :func:`seq_gather`,
:func:`gather_kv`) and :func:`sync_grads`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import socket
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from hero_tpu_torch.training import optim

# environment of a launch beyond torchrun's RANK / WORLD_SIZE /
# LOCAL_RANK / MASTER_ADDR / MASTER_PORT: an init method (e.g. a file://
# store) and the backend
INIT_METHOD_ENV = "HERO_DIST_INIT_METHOD"
BACKEND_ENV = "HERO_DIST_BACKEND"
TIMEOUT_S = 1800

_STATE: Dict[str, Any] = {}

# collectives issued by this process: calls and bytes of the gradient
# all-reduces, and bytes of every tensor collective and transfer the
# helpers here and in ``parallel/pipeline`` issue (read by benchmarks;
# never by the program).  A gradient leaf that no loss reads (None in the
# train step's leaf list) still travels in the all-reduce, as zeros: a
# rank cannot know that it is None on every other rank without a
# collective of its own, so its bytes count here.
STATS = {"all_reduce_calls": 0, "all_reduce_bytes": 0, "collective_bytes": 0}


def count_bytes(t: torch.Tensor) -> None:
    STATS["collective_bytes"] += t.numel() * t.element_size()


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group the launch describes and return this rank's
    device (``hero_tpu/parallel/mesh.py:37-63``).

    The rank and world size come from the arguments, else ``RANK`` /
    ``WORLD_SIZE``; the rendezvous from ``init_method``, else
    ``$HERO_DIST_INIT_METHOD`` (say ``file:///tmp/store``), else torchrun's
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).  With none of them
    set the call is a no-op and returns ``device``: a world of 1.  A
    second call returns the first call's device.

    The backend is ``backend``, else ``$HERO_DIST_BACKEND``, else
    ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU.  A CUDA rank
    runs on ``cuda:$LOCAL_RANK`` (default 0).  ``nccl`` refuses two ranks
    on one card (name ``gloo`` for that); no backend is ever chosen by
    catching a failure."""
    if is_initialized():
        return _STATE["device"]
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    init_method = init_method or env.get(INIT_METHOD_ENV)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    dev = torch.device(device)
    if rank is None and world_size is None and init_method is None:
        return _resolve(dev)
    if rank is None or world_size is None or init_method is None:
        raise ValueError(
            f"incomplete launch: rank={rank}, world_size={world_size}, "
            f"init_method={init_method!r} (set RANK, WORLD_SIZE and "
            f"MASTER_ADDR/MASTER_PORT or ${INIT_METHOD_ENV})")
    backend = backend or env.get(BACKEND_ENV) or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend runs ranks on CUDA devices; "
                         f"device {device!r} asks for the CPU")
    if dev.type == "cuda":
        dev = _resolve(torch.device("cuda",
                                    int(env.get("LOCAL_RANK", 0))))
        torch.cuda.set_device(dev)
    store, rank, world_size = next(tdist.rendezvous(
        init_method, rank, world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S)))
    where = f"{socket.gethostname()}/{dev}"
    store.set(f"hero_device/{rank}", where)
    places = [store.get(f"hero_device/{r}").decode()
              for r in range(world_size)]
    if backend == "nccl" and len(set(places)) < world_size:
        raise ValueError(
            f"nccl needs one card a rank, but the ranks run on {places}; "
            f"launch one rank a card, or name ${BACKEND_ENV}=gloo for "
            "ranks that share a card")
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world_size,
                             timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _STATE.update(device=dev, backend=backend, places=places)
    return dev


def _resolve(dev: torch.device) -> torch.device:
    from hero_tpu_torch import resolve_device
    return resolve_device(dev)


def shutdown_distributed() -> None:
    """Leave the process group (a no-op in a world of 1)."""
    global _GRID
    if is_initialized():
        tdist.destroy_process_group()
    _STATE.clear()
    _GROUPS.clear()
    _GRID = None


def backend() -> Optional[str]:
    return _STATE.get("backend")


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """Global rank 0: the one process that writes files and logs."""
    return rank() == 0


# ---------------------------------------------------------------------------
# the grid: (data, inner) over the world
# ---------------------------------------------------------------------------

INNER_AXES = ("stage", "model", "seq")


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a (data, inner) split of the world: global
    rank g = data_rank * inner_world + inner_rank.  ``data_group`` is the
    group of the ranks with this inner rank (None when it holds this rank
    alone), ``inner_group`` this rank's inner group (None in a plain
    world), ``inner_ranks`` its global ranks in inner order."""
    axis: str
    data_world: int
    inner_world: int
    data_rank: int
    inner_rank: int
    data_group: Any
    inner_group: Any
    inner_ranks: Tuple[int, ...]
    # the 2-rank groups of inner neighbours (i, i + 1) of this rank's
    # inner group, by i: the pipeline's stage-to-stage transfers
    pair_groups: Tuple[Any, ...] = ()


_GRID: Optional[Grid] = None
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def _group(ranks: Tuple[int, ...]):
    """The process group of ``ranks``, made once (every rank makes every
    group, in the same order)."""
    if ranks not in _GROUPS:
        _GROUPS[ranks] = tdist.new_group(list(ranks))
    return _GROUPS[ranks]


def _plain() -> Grid:
    w, r = world_size(), rank()
    return Grid("data", w, 1, r, 0, tdist.group.WORLD if w > 1 else None,
                None, (r,))


def init_grid(axis: str = "data", inner: int = 1) -> Grid:
    """Split the world into (data = W/inner, ``inner``) on ``axis`` (one
    of :data:`INNER_AXES`, or "data" with ``inner`` 1: the plain world)
    and make it this process's grid; every rank calls it with the same
    arguments (it makes the groups).  Raises when ``inner`` does not
    divide the world."""
    global _GRID
    if axis == "data":
        if inner != 1:
            raise ValueError("the data axis has no inner groups")
    elif axis not in INNER_AXES:
        raise ValueError(f"axis {axis!r}: one of data, {INNER_AXES}")
    w = world_size()
    if inner < 1 or w % inner:
        raise ValueError(
            f"{w} rank{'s' if w > 1 else ''} cannot hold {inner} {axis} "
            f"ranks a group: the {axis} count must divide the world")
    if inner == 1:
        _GRID = _plain()
        return _GRID
    n_data = w // inner
    inner_sets = [tuple(d * inner + i for i in range(inner))
                  for d in range(n_data)]
    data_sets = ([tuple(d * inner + i for d in range(n_data))
                  for i in range(inner)] if n_data > 1 else [])
    pair_sets = ([(r[i], r[i + 1]) for r in inner_sets
                  for i in range(inner - 1)] if axis == "stage" else [])
    for ranks in inner_sets + data_sets + pair_sets:
        _group(ranks)
    d, i = divmod(rank(), inner)
    mine = inner_sets[d]
    _GRID = Grid(axis, n_data, inner, d, i,
                 _GROUPS[data_sets[i]] if n_data > 1 else None,
                 _GROUPS[mine], mine,
                 tuple(_GROUPS[(mine[k], mine[k + 1])]
                       for k in range(inner - 1)) if pair_sets else ())
    return _GRID


def grid() -> Grid:
    """This process's grid: the last :func:`init_grid`'s, else the plain
    world's."""
    return _GRID if _GRID is not None else _plain()


def data_rank() -> int:
    return grid().data_rank


def data_world() -> int:
    return grid().data_world


def inner_rank() -> int:
    return grid().inner_rank


def inner_world() -> int:
    return grid().inner_world


def inner_axis() -> Optional[str]:
    """The grid's inner axis when it has several ranks, else None."""
    g = grid()
    return g.axis if g.inner_world > 1 else None


def barrier() -> None:
    if world_size() > 1:
        if backend() == "nccl":
            tdist.barrier(device_ids=[_STATE["device"].index])
        else:
            tdist.barrier()


@contextlib.contextmanager
def primary_first():
    """Run the block on the primary, then on the other ranks: files the
    primary creates in it exist when the others read them."""
    if not is_primary():
        barrier()
    yield
    if is_primary():
        barrier()


def host_allgather(obj: Any) -> list:
    """Every rank's picklable ``obj``, in rank order
    (``hero_tpu/parallel/mesh.py:140-160``: the reference's
    length-prefixed pickle gather); ``[obj]`` in a world of 1."""
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    tdist.all_gather_object(out, obj)
    return out


def data_allgather(obj: Any) -> list:
    """:func:`host_allgather` over the data group: one ``obj`` a data
    rank, in data-rank order (the ranks of an inner group hold the same
    share of rows, so it counts once)."""
    g = grid()
    if g.data_world == 1:
        return [obj]
    out: List[Any] = [None] * g.data_world
    tdist.all_gather_object(out, obj, group=g.data_group)
    return out


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a MAX all-reduce
    of one scalar)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=_collective_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item() > 0)


def _collective_device() -> torch.device:
    return _STATE["device"] if backend() == "nccl" else torch.device("cpu")


def _all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place; returns ``t``."""
    count_bytes(t)
    tdist.all_reduce(t, group=group)
    return t


def all_gather_tensor(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` (the same shape on each), concatenated on
    dim 0 in data-rank order; ``x`` with one data rank.  No gradient."""
    g = grid()
    if g.data_world == 1:
        return x
    return _all_gather(x, g.data_group)


def _all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) stacked on dim 0 in
    rank order."""
    world = tdist.get_world_size(group)
    # 2-byte elements (bf16, fp16) travel as their bytes: gloo has no
    # 16-bit types
    raw = x.contiguous()
    if raw.element_size() == 2:
        raw = raw.view(torch.uint8)
    out = torch.empty((world * raw.shape[0],) + tuple(raw.shape[1:]),
                      dtype=raw.dtype, device=raw.device)
    count_bytes(out)
    tdist.all_gather(list(out.chunk(world)), raw, group=group)
    return out.view(x.dtype)


def all_gather_flat(leaves: Sequence[torch.Tensor], group
                    ) -> List[List[torch.Tensor]]:
    """Every group rank's ``leaves`` (the same shapes and dtypes on each,
    any dtypes), in rank order, through one flat fp32 all-gather: exact
    copies."""
    n = tdist.get_world_size(group)
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    every = _all_gather(flat, group).reshape(n, -1)
    out = []
    for r in range(n):
        at, mine = 0, []
        for t in leaves:
            mine.append(every[r, at:at + t.numel()].reshape(t.shape)
                        .to(t.dtype))
            at += t.numel()
        out.append(mine)
    return out


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every group rank's ``x``, concatenated on ``dim`` in rank order."""
    if dim == 0:
        return _all_gather(x, group)
    out = _all_gather(x.movedim(dim, 0), group)
    return out.movedim(0, dim).contiguous()


def _narrow(x: torch.Tensor, dim: int, r: int, n: int) -> torch.Tensor:
    """Part ``r`` of ``n`` equal parts of ``x`` on ``dim``, contiguous."""
    m = x.shape[dim] // n
    return x.narrow(dim, r * m, m).contiguous()


def all_reduce_cast(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over the group in fp32 (gloo has no
    16-bit sums), in ``t``'s dtype."""
    f = t.detach().to(torch.float32, copy=True)
    _all_reduce_(f, group)
    return f.to(t.dtype)


# ---------------------------------------------------------------------------
# the train step's collectives
# ---------------------------------------------------------------------------

# make_train_step's group for a step of this process alone on its own
# batch, in a world of several ranks (the one-process reference of a
# data-parallel step)
ALONE = "alone"


def data_group():
    """The grid's data group when it has several ranks, else None (the
    group ``make_train_step`` reduces over unless given one; in a plain
    world of several ranks the default group)."""
    return grid().data_group


def all_reduce_flat(tensors: Sequence[Optional[torch.Tensor]], group=None,
                    like: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[torch.Tensor]:
    """The tensors summed over the group's ranks, as one flat fp32 buffer
    in the given order: one collective, deterministic for a fixed world
    and backend.  Each result has its input's shape and dtype.  A None
    entry is zeros of the shape of ``like``'s entry at its index (a
    gradient no loss reads; its result is fp32): an expanded view of one
    zero in the concatenation, no tensor of its own."""
    zero = None
    parts = []
    for i, t in enumerate(tensors):
        if t is None:
            if zero is None:
                zero = torch.zeros(1, dtype=torch.float32,
                                   device=like[i].device)
            parts.append(zero.expand(like[i].numel()))
        else:
            parts.append(t.detach().reshape(-1).float())
    flat = torch.cat(parts)
    STATS["all_reduce_calls"] += 1
    STATS["all_reduce_bytes"] += flat.numel() * 4
    _all_reduce_(flat, group)
    out, at = [], 0
    for i, t in enumerate(tensors):
        shape = like[i].shape if t is None else t.shape
        n = math.prod(shape)
        view = flat[at:at + n].reshape(shape)
        out.append(view if t is None else view.to(t.dtype))
        at += n
    return out


def all_reduce_grads(tree, group=None):
    """A gradient tree summed over the ranks
    (:func:`all_reduce_flat` over its leaves in tree order)."""
    leaves = optim.tree_leaves(tree)
    return optim.tree_unflatten(tree, all_reduce_flat(leaves, group))


@dataclasses.dataclass(frozen=True)
class _Dp:
    group: Any
    rank: int
    size: int


_DP: Optional[_Dp] = None


@contextlib.contextmanager
def data_parallel(group):
    """While the block runs (a train step's forward and backward), the
    losses reduce over ``group`` (None: a world of 1) and dropout folds
    the rank into its seeds."""
    global _DP
    prev = _DP
    _DP = None if group is None else _Dp(group, tdist.get_rank(group),
                                         tdist.get_world_size(group))
    try:
        yield
    finally:
        _DP = prev


def dp_size() -> int:
    """Ranks the current train step's losses reduce over (1 outside a
    step)."""
    return 1 if _DP is None else _DP.size


def global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Rule (a): ``total / max(count, 1)`` of the global batch from this
    rank's ``total`` and ``count``: the rank's sum over the all-reduced
    count, clamped after the reduce."""
    if _DP is None:
        return total / torch.clamp(count, min=1.0)
    n = _all_reduce_(count.detach().float().clone(), _DP.group)
    return total / torch.clamp(n, min=1.0)


def replicated(term: torch.Tensor) -> torch.Tensor:
    """Rule (b): a term every rank computes whole from gathered inputs,
    as this rank's share: the value ``term / W`` (the shares sum to the
    term), the gradient ``term``'s own (its inputs' backward already
    keeps this rank's slice)."""
    if _DP is None:
        return term
    return term - term.detach() * (1.0 - 1.0 / _DP.size)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Rule (b)'s input: every rank's rows of ``x`` on dim 0, in rank
    order (the single process's row order); the backward returns this
    rank's slice of the incoming gradient.  ``x`` itself outside a
    step."""
    if _DP is None:
        return x
    return _GatherRows.apply(x, _DP)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dp):
        ctx.rows, ctx.rank = x.shape[0], dp.rank
        return _all_gather(x, dp.group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def fold_rank(seed: Optional[int], inner: bool = False) -> Optional[int]:
    """A dropout site's seed with the data rank folded in while a step
    runs on several data ranks (their rows differ, so must their masks);
    the seed itself otherwise.  With ``inner`` (a tensor-parallel rank's
    own heads), or inside :func:`seq_region` (a sequence-parallel rank's
    own frames), the inner rank is folded in too: the ranks of an inner
    group otherwise run replicated computation, which must draw the same
    masks.  Draws that every rank must share (span-loss skips, sampled
    negatives, task and masking draws) never come here."""
    if seed is None:
        return seed
    if _DP is not None and _DP.size > 1:
        seed = zlib.crc32(f"rank{_DP.rank}".encode(), seed & 0xFFFFFFFF)
    g = grid()
    if (inner or _SEQ["region"]) and g.inner_world > 1:
        seed = zlib.crc32(f"{g.axis}{g.inner_rank}".encode(),
                          seed & 0xFFFFFFFF)
    return seed


# ---------------------------------------------------------------------------
# the inner axes: tensor and sequence parallelism
# ---------------------------------------------------------------------------

class _CopyToInner(torch.autograd.Function):
    """Megatron's f: identity forward, the inner group's sum backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_cast(g, grid().inner_group)


class _ReduceFromInner(torch.autograd.Function):
    """Megatron's g: the inner group's sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_cast(x, grid().inner_group)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_inner(x: torch.Tensor) -> torch.Tensor:
    """Before a column-parallel product: ``x`` forward, its gradient
    summed over the model group backward (each rank's heads add theirs)."""
    return _CopyToInner.apply(x)


def reduce_from_inner(x: torch.Tensor) -> torch.Tensor:
    """After a row-parallel product: the partial products summed over the
    model group forward (in fp32, in ``x``'s dtype), identity backward."""
    return _ReduceFromInner.apply(x)


# sequence parallelism: the toggle (enable_seq_parallel) and the region a
# rank spends on its own frames (seq_region)
_SEQ = {"enabled": False, "region": False}


def enable_seq_parallel(enabled: bool) -> None:
    """Turn sequence parallelism over the grid's ``seq`` groups on or off
    for the calls that follow (``hero_tpu/parallel/mesh.py:217-225``):
    ``models/model.forward_repr`` then runs the c-encoder on this rank's
    frames (:func:`seq_parallel`)."""
    if enabled and grid().axis != "seq":
        raise ValueError(f"sequence parallelism needs a seq grid "
                         f"(init_grid('seq', S)); the grid is "
                         f"{grid().axis!r}")
    _SEQ["enabled"] = bool(enabled)


def seq_parallel() -> bool:
    """True while sequence parallelism is on over several seq ranks."""
    return _SEQ["enabled"] and grid().axis == "seq" and inner_world() > 1


@contextlib.contextmanager
def seq_region():
    """While the block runs, the rank works on its own frames: dropout
    folds the seq rank (:func:`fold_rank`) and self-attention meets every
    rank's keys and values (:func:`gather_kv`)."""
    prev = _SEQ["region"]
    _SEQ["region"] = True
    try:
        yield
    finally:
        _SEQ["region"] = prev


def in_seq_region() -> bool:
    return _SEQ["region"]


class _SeqSlice(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim):
        g = grid()
        ctx.dim = dim
        return _narrow(x, dim, g.inner_rank, g.inner_world)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad.contiguous(), ctx.dim,
                           grid().inner_group), None


class _SeqGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _gather_dim(x.contiguous(), dim, grid().inner_group)

    @staticmethod
    def backward(ctx, grad):
        g = grid()
        return _narrow(grad, ctx.dim, g.inner_rank, g.inner_world), None


class _GatherKv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _gather_dim(x.contiguous(), dim, grid().inner_group)

    @staticmethod
    def backward(ctx, grad):
        # every rank's gradient of every frame's key, summed; each rank
        # keeps its own frames' (a reduce-scatter)
        g = grid()
        total = all_reduce_cast(grad.contiguous(), g.inner_group)
        return _narrow(total, ctx.dim, g.inner_rank, g.inner_world), None


def seq_slice(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This seq rank's part of ``x`` on ``dim`` (replicated on the group);
    backward: every rank's part gathered, so the replicated computation
    before it gets the whole gradient on every rank."""
    return _SeqSlice.apply(x, dim)


def seq_gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every seq rank's part of ``x`` on ``dim``, in rank order; backward:
    this rank's slice (as ``_GatherRows`` does on dim 0)."""
    return _SeqGather.apply(x, dim)


def gather_kv(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every seq rank's keys (or values) of ``x`` on ``dim``; backward:
    the gradients of this rank's frames summed over the ranks."""
    return _GatherKv.apply(x, dim)


class _SyncGrads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, *leaves):
        ctx.like = [(t.shape, t.dtype, t.device) for t in leaves]
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=dt, device=dv) if g is None else g
                 for g, (s, dt, dv) in zip(grads, ctx.like)]
        return tuple(all_reduce_flat(grads, grid().inner_group))


def sync_grads(tree):
    """``tree``'s leaves forward; backward, their gradients summed over
    the inner group in one flat buffer: parameters that each seq rank
    applies to its own frames get the whole gradient on every rank."""
    leaves = optim.tree_leaves(tree)
    if not torch.is_grad_enabled() or not any(t.requires_grad
                                              for t in leaves):
        return tree
    return optim.tree_unflatten(tree, list(_SyncGrads.apply(*leaves)))


# ---------------------------------------------------------------------------
# batches and replicas
# ---------------------------------------------------------------------------

def shard_rows(batch: Dict[str, Any], accum_steps: int = 1, *,
               items: Optional[int] = None,
               replicated_keys: Iterable[str] = (),
               row_index_keys: Optional[Dict[str, str]] = None
               ) -> Dict[str, Any]:
    """This data rank's contiguous rows of a global numpy batch
    (``hero_tpu/parallel/mesh.py:108-134``): dim 0 of every array, or dim
    1 under a leading accumulation axis; ``replicated_keys`` and arrays
    without that axis (the curriculum's scalars) stay whole.  ``items``,
    when given, is the global item count a batch of several rows an item
    holds (VIOLIN's pairs, VideoQA's answers): it must divide by W, so an
    item's rows never split.  ``row_index_keys`` ({key: the key whose
    rows it indexes}, TVC's ``cap_vidx``) are rebased to the rank's own
    rows, which they must index.  A batch that does not divide by W
    raises."""
    r, world = data_rank(), data_world()
    if world == 1:
        return batch
    axis = 1 if accum_steps > 1 else 0
    if items is not None and items % world:
        raise ValueError(f"a global batch of {items} items does not divide "
                         f"by {world} ranks")
    keep = set(replicated_keys)
    out = {}
    for k, v in batch.items():
        if k in keep or not isinstance(v, np.ndarray) or v.ndim <= axis:
            out[k] = v
            continue
        n = v.shape[axis]
        if n % world:
            raise ValueError(
                f"a global batch whose {k!r} has {n} rows (axis {axis}) "
                f"does not divide by {world} ranks")
        m = n // world
        out[k] = v[r * m:(r + 1) * m] if axis == 0 else \
            v[:, r * m:(r + 1) * m]
    for k, of in (row_index_keys or {}).items():
        if k in out and of in out:
            m = out[of].shape[axis]
            local = out[k] - r * m
            if local.size and (local.min() < 0 or local.max() >= m):
                raise ValueError(f"rank {r}'s {k!r} rows index another "
                                 f"rank's {of!r} rows")
            out[k] = local.astype(out[k].dtype)
    return out


def check_replicas(tree, what: str = "parameters") -> None:
    """Raise unless every rank's ``tree`` has the bit-identical per-leaf
    fp64 sums of the first rank with its inner rank: the replicas of a
    data-parallel run never drift (the ranks of an inner group hold
    different stages or shards)."""
    if world_size() == 1:
        return
    sums = host_allgather((inner_rank(), torch.stack([
        t.detach().double().sum()
        for t in optim.tree_leaves(tree)]).cpu().numpy()))
    first = {}
    for r, (i, s) in enumerate(sums):
        r0 = first.setdefault(i, r)
        ref = sums[r0][1]
        if s.tobytes() != ref.tobytes():
            leaf = int(np.flatnonzero(s != ref)[0])
            path = "/".join(optim.tree_paths(tree)[leaf])
            raise RuntimeError(
                f"the {what} of rank {r} drifted from rank {r0}'s (first "
                f"at {path}: {s[leaf]!r} vs {ref[leaf]!r})")


def assert_same_batch(batch: Dict[str, Any], what: str = "batch") -> None:
    """Raise unless every rank holds the same host batch (shapes and fp64
    content sums; ``hero_tpu/evaluation/pretrain_val.py:41-54``): a rank
    whose replicated stream drifted fails loudly."""
    if world_size() == 1:
        return
    local = np.float64(0.0)
    for k in sorted(batch):
        if k.startswith("__"):
            continue
        a = np.asarray(batch[k])
        local += zlib.crc32(f"{k}:{a.shape}".encode()) % (1 << 20)
        local += float(np.asarray(a, np.float64).sum())
    sums = host_allgather(float(local))
    if any(abs(s - sums[0]) > 1e-6 * max(1.0, abs(sums[0])) for s in sums):
        raise RuntimeError(f"the {what} streams diverged across ranks "
                           f"(checksums {sums})")
