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
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence

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
# all-reduces (read by benchmarks; never by the program)
STATS = {"all_reduce_calls": 0, "all_reduce_bytes": 0}


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
    if is_initialized():
        tdist.destroy_process_group()
    _STATE.clear()


def backend() -> Optional[str]:
    return _STATE.get("backend")


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """Rank 0: the one process that writes files and logs."""
    return rank() == 0


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
    tdist.all_reduce(t, group=group)
    return t


def all_gather_tensor(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated on dim 0
    in rank order; ``x`` in a world of 1.  No gradient."""
    if world_size() == 1:
        return x
    return _all_gather(x)


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
    tdist.all_gather(list(out.chunk(world)), raw, group=group)
    return out.view(x.dtype)


# ---------------------------------------------------------------------------
# the train step's collectives
# ---------------------------------------------------------------------------

# make_train_step's group for a step of this process alone on its own
# batch, in a world of several ranks (the one-process reference of a
# data-parallel step)
ALONE = "alone"


def data_group():
    """The default group when the world has several ranks, else None
    (the group ``make_train_step`` reduces over unless given one)."""
    return tdist.group.WORLD if world_size() > 1 else None


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None
                    ) -> List[torch.Tensor]:
    """The tensors summed over the group's ranks, as one flat fp32 buffer
    in the given order: one collective, deterministic for a fixed world
    and backend.  Each result has its input's shape and dtype."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    STATS["all_reduce_calls"] += 1
    STATS["all_reduce_bytes"] += flat.numel() * 4
    _all_reduce_(flat, group)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).to(t.dtype))
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


def fold_rank(seed: Optional[int]) -> Optional[int]:
    """A dropout site's seed with the rank folded in while a step runs on
    several ranks (their rows differ, so must their masks); the seed
    itself otherwise.  Draws that every rank must share (span-loss skips,
    sampled negatives, task and masking draws) never come here."""
    if seed is None or _DP is None or _DP.size == 1:
        return seed
    return zlib.crc32(f"rank{_DP.rank}".encode(), seed & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# batches and replicas
# ---------------------------------------------------------------------------

def shard_rows(batch: Dict[str, Any], accum_steps: int = 1, *,
               items: Optional[int] = None,
               replicated_keys: Iterable[str] = (),
               row_index_keys: Optional[Dict[str, str]] = None
               ) -> Dict[str, Any]:
    """This rank's contiguous rows of a global numpy batch
    (``hero_tpu/parallel/mesh.py:108-134``): dim 0 of every array, or dim
    1 under a leading accumulation axis; ``replicated_keys`` and arrays
    without that axis (the curriculum's scalars) stay whole.  ``items``,
    when given, is the global item count a batch of several rows an item
    holds (VIOLIN's pairs, VideoQA's answers): it must divide by W, so an
    item's rows never split.  ``row_index_keys`` ({key: the key whose
    rows it indexes}, TVC's ``cap_vidx``) are rebased to the rank's own
    rows, which they must index.  A batch that does not divide by W
    raises."""
    r, world = rank(), world_size()
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
    """Raise unless every rank's ``tree`` has bit-identical per-leaf fp64
    sums: the replicas of a data-parallel run never drift."""
    if world_size() == 1:
        return
    sums = host_allgather(torch.stack([
        t.detach().double().sum()
        for t in optim.tree_leaves(tree)]).cpu().numpy())
    for r, s in enumerate(sums[1:], 1):
        if s.tobytes() != sums[0].tobytes():
            leaf = int(np.flatnonzero(s != sums[0])[0])
            path = "/".join(optim.tree_paths(tree)[leaf])
            raise RuntimeError(
                f"the {what} of rank {r} drifted from rank 0's (first at "
                f"{path}: {s[leaf]!r} vs {sums[0][leaf]!r})")


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
