"""Atomic-commit checkpoints of nested dicts of tensors, single process.

Port of the JAX package's ``train/checkpoint.py`` with its on-disk format,
so that a checkpoint written by either package restores into the other:

* ``<dir>/step_<n:010d>/arrays.0.npz``: the leaves, keyed by tree path —
  dict keys as they are, tuple indices as ``#i``, joined by ``/`` (the
  JAX package's ``_path_str``);
* ``meta.json`` with ``step``, ``process_count`` and a SHA-256 per shard
  under ``checksums``, plus the caller's meta;
* the ``COMMITTED`` marker, written last, after every payload byte is
  fsynced; staging in ``tmp.<step>.0`` and one atomic rename;
* retention of the newest ``keep`` committed steps;
* a restore that verifies the shard's checksum and falls back to the
  previous committed step when it does not match.

Not ported: the multi-process shared commit and the fault-injection site
of the JAX module.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

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


def save_checkpoint(
    directory: str,
    step: int,
    state: Tree,
    *,
    meta: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Atomic checkpoint commit: stage into ``tmp.<step>.0``, fsync the
    payload, write ``meta.json`` (with the payload's SHA-256) and the
    ``COMMITTED`` marker, rename to ``step_<n>``, then drop all but the
    newest ``keep`` committed steps."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = os.path.join(directory, f"tmp.{step}.0")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _to_numpy(v) for k, v in flatten_state(state).items()}
    with open(os.path.join(tmp, "arrays.0.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    checksums = {"arrays.0.npz": _sha256_file(os.path.join(tmp, "arrays.0.npz"))}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "process_count": 1, "checksums": checksums,
                   **(meta or {})}, f)
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
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    # stale staging dirs of this process's crashed writes, older than the
    # newest commit (a newer one may be a writer still mid-commit)
    newest = steps[-1] if steps else None
    for name in os.listdir(directory):
        parts = name.split(".")
        if len(parts) != 3 or parts[0] != "tmp" or parts[2] != "0":
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


def verify_payload(directory: str, step: int) -> Optional[str]:
    """None when the shard of a committed step matches the SHA-256 recorded
    at commit time (or the checkpoint has none), else what is wrong."""
    _, meta = read_meta(directory, step=step)
    recorded = (meta.get("checksums") or {}).get("arrays.0.npz")
    if recorded is None:
        return None
    target = os.path.join(_step_dir(directory, step), "arrays.0.npz")
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
) -> Tuple[int, Tree, Dict[str, Any]]:
    """Restore the newest (or given) committed step into ``template``'s
    structure.  A shard whose checksum does not match is skipped with a
    warning for the previous committed step; only when every candidate is
    corrupt does it raise.  Use the *returned* step and meta."""
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
        problem = verify_payload(directory, s)
        if problem is not None:
            warnings.warn(f"{problem}; falling back to the previous committed step",
                          RuntimeWarning)
            print(f"restore_checkpoint: {problem}", file=sys.stderr, flush=True)
            corrupt.append(problem)
            continue
        _, meta = read_meta(directory, step=s)
        if int(meta.get("process_count", 1)) != 1:
            raise ValueError(
                f"checkpoint step {s} in {directory} was written by "
                f"{meta['process_count']} processes; the port restores "
                "single-process checkpoints only"
            )
        with np.load(os.path.join(_step_dir(directory, s), "arrays.0.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return s, _unflatten(template, flat), meta
    raise RuntimeError(
        f"every committed checkpoint in {directory} failed payload "
        f"verification: {'; '.join(corrupt)}"
    )
