"""Atomic-commit checkpoints of nested dicts of tensors, from one process
or several.

Port of the JAX package's ``train/checkpoint.py`` with its on-disk format,
so that a checkpoint written by either package restores into the other:

* ``<dir>/step_<n:010d>/arrays.<proc>.npz``: the leaves of each process's
  shard, keyed by tree path —
  dict keys as they are, tuple indices as ``#i``, joined by ``/`` (the
  JAX package's ``_path_str``);
* ``meta.json`` with ``step``, ``process_count`` and a SHA-256 per shard
  under ``checksums``, plus the caller's meta;
* the ``COMMITTED`` marker, written last, after every payload byte is
  fsynced; staging in ``tmp.<step>.0`` and one atomic rename;
* retention of the newest ``keep`` committed steps;
* a restore that verifies the shard's checksum and falls back to the
  previous committed step when it does not match;
* the multi-process commit: every process writes its own shard
  ``arrays.<proc>.npz`` into one shared staging directory
  ``tmp.<step>.shared``, fsyncs it, and only after a barrier does process 0
  write ``meta.json`` and the marker and rename, so a checkpoint never
  commits with a shard missing, and a crash before the rename leaves the
  previous checkpoint the newest;
* the ``corrupt_checkpoint_payload`` fault site (``resilience.faults``):
  after the commit of the armed step, this process flips bytes of its own
  committed shard, so the restore's checksum check has a real fault to
  catch.

An elastic restore (another process count than the writers') reads shard
0, which every writer's replicated state shares, with
``expect_process_count=None``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.resilience.faults import FaultPlan, corrupt_file

Tree = Any
_SEP = "/"


def flatten_state(tree: Tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """{path: leaf} with the JAX package's path strings."""
    if isinstance(tree, Mapping):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten_state(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_state(v, prefix + (f"#{i}",)))
        return out
    return {_SEP.join(prefix): tree}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _unflatten(template: Tree, flat: Dict[str, np.ndarray],
               prefix: Tuple[str, ...] = ()) -> Tree:
    """``template``'s structure with each leaf read from ``flat``: a tensor
    leaf comes back as a tensor of its dtype on its device."""
    if isinstance(template, Mapping):
        return {k: _unflatten(v, flat, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, flat, prefix + (f"#{i}",))
                              for i, v in enumerate(template))
    key = _SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(template.shape)}"
        )
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr, dtype=template.dtype, device=template.device)
    return arr


def _fsync_dir(path: str) -> None:
    """fsync a directory so its entries (renames, new files) are durable.
    Best-effort on platforms whose filesystems reject directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _write_shard(tmp: str, process_index: int, state: Tree) -> None:
    """One process's shard, fsynced before anyone may commit."""
    flat = {k: _to_numpy(v) for k, v in flatten_state(state).items()}
    with open(os.path.join(tmp, f"arrays.{process_index}.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())


def _commit(directory: str, tmp: str, final: str, step: int,
            meta: Optional[Dict[str, Any]], process_count: int) -> None:
    """``meta.json`` (with a SHA-256 per shard) and the ``COMMITTED`` marker,
    written after every payload byte is on disk, then one atomic rename."""
    checksums = {name: _sha256_file(os.path.join(tmp, name))
                 for name in sorted(os.listdir(tmp))
                 if name.startswith("arrays.") and name.endswith(".npz")}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "process_count": process_count,
                   "checksums": checksums, **(meta or {})}, f)
        f.flush()
        os.fsync(f.fileno())
    # the marker last: every payload byte is on disk before it exists
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)


def save_checkpoint(
    directory: str,
    step: int,
    state: Tree,
    *,
    meta: Optional[Dict[str, Any]] = None,
    keep: int = 3,
    process_index: int = 0,
    process_count: int = 1,
    barrier: Optional[Callable[[str], None]] = None,
) -> str:
    """Atomic checkpoint commit; ``state`` is this process's shard.

    One process: stage into ``tmp.<step>.<proc>``, fsync the payload, write
    ``meta.json`` and the marker, rename to ``step_<n>``, then drop all but
    the newest ``keep`` committed steps.  Several processes
    (``process_count > 1``, ``barrier`` required, e.g. the engine's): all
    stage into one shared ``tmp.<step>.shared``, and the commit waits for
    every shard:

        proc 0 creates staging  ->  barrier  ->  all write shards
        ->  barrier  ->  proc 0 writes meta+marker, renames  ->  barrier
    """
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    if process_count <= 1:
        tmp = os.path.join(directory, f"tmp.{step}.{process_index}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _write_shard(tmp, process_index, state)
        _commit(directory, tmp, final, step, meta, process_count=1)
        _corrupt_if_armed(final, step, process_index)
        _gc(directory, keep, process_index=process_index)
        return final
    if barrier is None:
        raise ValueError(
            "multi-process save_checkpoint needs a barrier callable "
            "(e.g. the engine's barrier) to order the shared commit"
        )
    tmp = os.path.join(directory, f"tmp.{step}.shared")
    if process_index == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    barrier(f"ckpt-stage-{step}")
    _write_shard(tmp, process_index, state)
    barrier(f"ckpt-shards-{step}")
    if process_index == 0:
        _commit(directory, tmp, final, step, meta, process_count=process_count)
        _gc(directory, keep, process_index=0, shared=True)
    # nobody returns (and possibly starts the next checkpoint, or restores)
    # until the commit is visible everywhere
    barrier(f"ckpt-commit-{step}")
    _corrupt_if_armed(final, step, process_index)
    return final


def _corrupt_if_armed(final: str, step: int, process_index: int) -> None:
    """``corrupt_checkpoint_payload`` fault site: flips bytes in this
    process's just-committed shard, so a restore meets a checkpoint that
    looks committed but whose payload is garbage."""
    plan = FaultPlan.from_env()
    if not plan.corrupt_checkpoint_payload(step, process=process_index):
        return
    target = os.path.join(final, f"arrays.{process_index}.npz")
    n = corrupt_file(target)
    print(f"fault injection: corrupt_checkpoint_payload flipped {n} bytes "
          f"in {target} (step {step})", file=sys.stderr, flush=True)


def _gc(directory: str, keep: int, *, process_index: int = 0,
        shared: bool = False) -> None:
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    # stale staging dirs of this process's own crashed writes (process 0 of
    # a shared commit also owns ``tmp.<step>.shared``), older than the
    # newest commit: a newer one may be a writer still mid-commit
    newest = steps[-1] if steps else None
    for name in os.listdir(directory):
        parts = name.split(".")
        owned = {str(process_index), "shared"} if shared else {str(process_index)}
        if len(parts) != 3 or parts[0] != "tmp" or parts[2] not in owned:
            continue
        try:
            tmp_step = int(parts[1])
        except ValueError:
            continue
        if newest is not None and tmp_step < newest:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return [int(name[len("step_"):]) for name in os.listdir(directory)
            if name.startswith("step_")
            and os.path.exists(os.path.join(directory, name, "COMMITTED"))]


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def read_meta(
    directory: str, *, step: Optional[int] = None
) -> Tuple[int, Dict[str, Any]]:
    """A committed checkpoint's ``meta.json``, without reading its arrays."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    with open(os.path.join(_step_dir(directory, step), "meta.json")) as f:
        return step, json.load(f)


def verify_payload(directory: str, step: int, *, process_index: int = 0) -> Optional[str]:
    """None when this process's shard of a committed step matches the
    SHA-256 recorded at commit time (or the checkpoint has none), else what
    is wrong."""
    _, meta = read_meta(directory, step=step)
    name = f"arrays.{process_index}.npz"
    recorded = (meta.get("checksums") or {}).get(name)
    if recorded is None:
        return None
    target = os.path.join(_step_dir(directory, step), name)
    try:
        actual = _sha256_file(target)
    except OSError as exc:
        return f"checkpoint step {step}: cannot read {target}: {exc}"
    if actual != recorded:
        return (f"checkpoint step {step}: payload {target} is corrupt "
                f"(sha256 {actual[:12]}… != committed {recorded[:12]}…)")
    return None


def restore_checkpoint(
    directory: str,
    template: Tree,
    *,
    step: Optional[int] = None,
    process_index: int = 0,
    expect_process_count: Optional[int] = 1,
) -> Tuple[int, Tree, Dict[str, Any]]:
    """Restore this process's shard of the newest (or given) committed step
    into ``template``'s structure.  A shard whose checksum does not match is
    skipped with a warning for the previous committed step; only when every
    candidate is corrupt does it raise.  Use the *returned* step and meta.

    ``expect_process_count`` checks the writers' world size before any
    array loads: a checkpoint of N processes holds N shards with their
    process-local residuals, which another world size would mis-restore.
    Elastic readers, which re-initialise the rank-local state and read the
    replicated shard 0, pass ``None``."""
    committed = sorted(_committed_steps(directory), reverse=True)
    if step is not None:
        candidates = [s for s in committed if s <= step]
        if step not in committed:
            candidates = [step] + candidates  # explicit step: try, fail loud
    else:
        candidates = committed
    if not candidates:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    corrupt: List[str] = []
    for s in candidates:
        problem = verify_payload(directory, s, process_index=process_index)
        if problem is not None:
            warnings.warn(f"{problem}; falling back to the previous committed step",
                          RuntimeWarning)
            print(f"restore_checkpoint: {problem}", file=sys.stderr, flush=True)
            corrupt.append(problem)
            continue
        _, meta = read_meta(directory, step=s)
        ckpt_procs = int(meta.get("process_count", 1))
        if expect_process_count is not None and ckpt_procs != expect_process_count:
            raise ValueError(
                f"checkpoint step {s} in {directory} was written by "
                f"{ckpt_procs} process(es) but this reader expects "
                f"{expect_process_count}; restore with TrainerConfig.elastic=True "
                "to rescale across host counts (losing a host is a rescale event)"
            )
        with np.load(os.path.join(_step_dir(directory, s),
                                  f"arrays.{process_index}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return s, _unflatten(template, flat), meta
    raise RuntimeError(
        f"every committed checkpoint in {directory} failed payload "
        f"verification: {'; '.join(corrupt)}"
    )
