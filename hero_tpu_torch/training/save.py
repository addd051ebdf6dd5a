"""Checkpoints in the JAX package's file layout (counterpart of
``hero_tpu/training/save.py``).

- :class:`ModelSaver` writes ``ckpt/model_step_N.npz``: the flat JAX
  parameter dict (``{"a/b/c": array}``), with the ``__vocab_padded__``
  marker when the pad decision is known.
- :class:`TrainingRestorer` writes ``restore.npz`` (parameters under
  ``params/``, AdamW moments under ``mu/`` and ``nu/``, ``__step__``),
  keeps the previous one as ``restore_backup.npz``, refuses to resume when
  ``restore_hps.json`` differs from the run's, and falls back to the
  backup when the main file is unreadable.
- :func:`save_training_meta` writes ``log/hps.json``,
  ``log/model_config.json`` and the git sha (or a zip of the package).

The port's trees go through the inverse bridge
(``convert/from_jax.to_jax_params``) with the run's ``template``, the flat
JAX tree it started from, so ``hero_tpu.training.save.load_params`` and
``TrainingRestorer.restore`` read these files and the port reads theirs.

The device-to-host copy runs on the calling thread; only the file write
goes to :class:`AsyncCheckpointWriter`'s thread.  Every write is tmp file
plus rename, so a crash never truncates a checkpoint.  Each save appends
``{"step", "copy_ms", "write_ms", "bytes"}`` to the saver's ``records``
(the write's fields once it has ended).  One process writes: the port
runs on one card.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import threading
import time
import zipfile
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from hero_tpu_torch.convert.from_jax import (load_jax_train_state,
                                             to_jax_params,
                                             to_jax_train_state)
from hero_tpu_torch.training.optim import tree_leaves
from hero_tpu_torch.utils.logger import LOGGER


def _atomic_savez(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write ``flat`` to ``path`` via tmp file + rename (crash-safe)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class AsyncCheckpointWriter:
    """One background thread for checkpoint file I/O.

    ``submit(job)`` waits for the previous job to finish, then enqueues a
    no-arg callable: writes stay ordered and at most one host snapshot
    waits in the writer.  A job's exception is raised on the next
    ``submit``/``flush``.  Jobs get host data only."""

    def __init__(self):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = \
            queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._started = False

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                job()
            except BaseException as e:   # noqa: BLE001 - raised on submit
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("checkpoint write failed") from err

    def submit(self, job: Callable[[], None]) -> None:
        if not self._started:
            self._thread.start()
            self._started = True
        self._q.join()
        self._check()
        self._q.put(job)

    def flush(self) -> None:
        """Wait for every pending write; raise a writer error."""
        if self._started:
            self._q.join()
        self._check()

    def close(self) -> None:
        self.flush()
        if self._started:
            self._q.put(None)
            self._thread.join()
            self._started = False


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_params(path: str, params) -> None:
    """A JAX-layout tree (nested or flat dict of arrays) as ``.npz``."""
    np.savez(path, **flatten_tree(params))


def load_params(path: str) -> Any:
    """The nested JAX-layout tree of an ``.npz`` (``__`` keys left out)."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files
                               if not k.startswith("__")})


def checkpoint_vocab_padded(path: str) -> Optional[bool]:
    """A ModelSaver checkpoint's ``vocab_padded`` marker; None if it has
    none."""
    with np.load(path) as z:
        if "__vocab_padded__" in z.files:
            return bool(z["__vocab_padded__"])
    return None


def _wait_for(tree) -> float:
    """Wait for the device work that produces ``tree``; the clock after,
    so a record's ``copy_ms`` counts the copy and not the step before."""
    device = tree_leaves(tree)[0].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _write_job(path: str, flat: Dict[str, np.ndarray], record: dict,
               before: Optional[Callable[[], None]] = None
               ) -> Callable[[], None]:
    def job():
        t0 = time.perf_counter()
        if before is not None:
            before()
        _atomic_savez(path, flat)
        record["write_ms"] = 1e3 * (time.perf_counter() - t0)
        record["bytes"] = os.path.getsize(path)
    return job


class ModelSaver:
    """``{prefix}_{step}.{suffix}`` snapshots of the parameters in the JAX
    layout.  ``template`` is the flat JAX tree the run started from (the
    inverse bridge takes the keys the port does not hold from it);
    ``vocab_padded`` the pad decision of the checkpoint conversion, None
    when unknown (no marker is written)."""

    def __init__(self, output_dir: str, template: Mapping[str, np.ndarray],
                 prefix: str = "model_step", suffix: str = "npz",
                 vocab_padded: Optional[bool] = None,
                 writer: Optional[AsyncCheckpointWriter] = None):
        self.output_dir = output_dir
        self.template = template
        self.prefix = prefix
        self.suffix = suffix
        self.vocab_padded = vocab_padded
        self.writer = writer
        self.records: List[dict] = []
        os.makedirs(output_dir, exist_ok=True)

    def save(self, params, step: int) -> str:
        path = os.path.join(self.output_dir,
                            f"{self.prefix}_{step}.{self.suffix}")
        t0 = _wait_for(params)
        flat = to_jax_params(params, self.template)
        if self.vocab_padded is not None:
            flat["__vocab_padded__"] = np.asarray(self.vocab_padded)
        record = {"step": step, "copy_ms": 1e3 * (time.perf_counter() - t0)}
        self.records.append(record)
        job = _write_job(path, flat, record)
        if self.writer is not None:
            self.writer.submit(job)
        else:
            job()
        return path

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()


def save_training_meta(output_dir: str, hps: Dict[str, Any],
                       model_config: Dict[str, Any]) -> None:
    """``log/hps.json``, ``log/model_config.json`` and
    ``log/git_info.json`` (or ``log/code.zip`` of the package where git
    cannot tell the commit), the JAX package's schema (reference
    utils/save.py:21-73)."""
    os.makedirs(os.path.join(output_dir, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "ckpt"), exist_ok=True)
    with open(os.path.join(output_dir, "log", "hps.json"), "w") as f:
        json.dump(hps, f, indent=4)
    with open(os.path.join(output_dir, "log", "model_config.json"),
              "w") as f:
        json.dump(model_config, f, indent=4)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL,
            cwd=pkg_root, timeout=30).decode().strip()
    except (OSError, subprocess.SubprocessError):
        from hero_tpu_torch.utils.basic_utils import make_zipfile
        make_zipfile(pkg_root, os.path.join(output_dir, "log", "code.zip"),
                     exclude_dirs=("build", "__pycache__"))
        return
    with open(os.path.join(output_dir, "log", "git_info.json"), "w") as f:
        json.dump({"git_sha": sha}, f)


class TrainingRestorer:
    """Preemption-safe resume (reference utils/save.py:136-181):
    ``restore.npz`` every ``save_steps`` (:meth:`step`) and on demand
    (:meth:`save`), read back by :meth:`restore`.  ``template`` as
    :class:`ModelSaver`'s, needed before the first save; :meth:`restore`
    sets it to the restored parameters, which then carry the keys the
    port does not hold."""

    def __init__(self, output_dir: str, hps: Dict[str, Any],
                 template: Optional[Mapping[str, np.ndarray]] = None,
                 writer: Optional[AsyncCheckpointWriter] = None):
        self.save_path = os.path.join(output_dir, "restore.npz")
        self.backup_path = os.path.join(output_dir, "restore_backup.npz")
        self.hps_path = os.path.join(output_dir, "restore_hps.json")
        self.template = template
        self.writer = writer
        self.records: List[dict] = []
        self.saved_step: Optional[int] = None
        self.restore_ms: Optional[float] = None
        os.makedirs(output_dir, exist_ok=True)
        if os.path.exists(self.hps_path):
            with open(self.hps_path) as f:
                restore_hps = json.load(f)
            if restore_hps != hps:
                raise ValueError(
                    f"hps changed between runs ({restore_hps} != {hps}); "
                    "refusing to resume")
        else:
            tmp = self.hps_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(hps, f, indent=4)
            os.replace(tmp, self.hps_path)
        self.global_step = 0

    def can_restore(self) -> bool:
        return (os.path.exists(self.save_path)
                or os.path.exists(self.backup_path))

    def step(self, train_state, save_steps: int) -> None:
        """Call after every optimizer step: saves every ``save_steps``."""
        self.global_step = int(train_state.global_step)
        if self.global_step % save_steps == 0:
            self.save(train_state)

    def save(self, train_state) -> None:
        t0 = _wait_for(train_state.params)
        params, mu, nu, step = to_jax_train_state(train_state,
                                                  self.template)
        flat = {**{f"params/{k}": v for k, v in params.items()},
                **{f"mu/{k}": v for k, v in mu.items()},
                **{f"nu/{k}": v for k, v in nu.items()},
                "__step__": np.asarray(step)}
        record = {"step": step, "copy_ms": 1e3 * (time.perf_counter() - t0)}
        self.records.append(record)
        self.saved_step = step

        def keep_backup():
            # in the writer, before the write: a crash at any point leaves
            # one complete file
            if os.path.exists(self.save_path):
                os.replace(self.save_path, self.backup_path)

        job = _write_job(self.save_path, flat, record, before=keep_backup)
        if self.writer is not None:
            self.writer.submit(job)
        else:
            job()

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def read(self):
        """(flat params, flat mu, flat nu, step) of the newest readable
        restore file, the backup when the main file is unreadable."""
        candidates = [p for p in (self.save_path, self.backup_path)
                      if os.path.exists(p)]
        for path in candidates:
            try:
                with np.load(path) as z:
                    step = int(z["__step__"])
                    trees: Dict[str, Dict[str, np.ndarray]] = {}
                    for k in z.files:
                        if k != "__step__":
                            tree, _, key = k.partition("/")
                            trees.setdefault(tree, {})[key] = z[k]
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:
                LOGGER.warning("unreadable checkpoint %s (%r); falling "
                               "back", path, e)
                continue
            LOGGER.info("restored training state at step %d from %s",
                        step, path)
            return trees["params"], trees["mu"], trees["nu"], step
        raise RuntimeError(
            f"no readable restore checkpoint among {candidates}")

    def restore(self, device="cuda"):
        """The restored ``TrainState`` on ``device`` (AdamW's step and the
        global step both ``__step__``); sets ``global_step``, ``template``
        and ``restore_ms``."""
        t0 = time.perf_counter()
        params, mu, nu, step = self.read()
        state = load_jax_train_state(params, mu, nu, step, step, device)
        self.template = params
        self.global_step = step
        self.restore_ms = 1e3 * (time.perf_counter() - t0)
        return state
