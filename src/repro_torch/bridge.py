"""Parameter bridge between the JAX package's pytrees and the port, the map
from the JAX package's kernel and engine names to the port's, and the
placement of parameters on the port's device.

Torch cannot reproduce ``jax.random``, so a test gives both models the same
weights by converting the JAX parameters (as numpy) into the port's nested
dict of tensors.  Flat keys are the path strings that the JAX package's
``train/checkpoint.py::_flatten`` writes: dict keys joined by ``/``, e.g.
``layer_0/symcon/w_L0_nu2``.  No JAX import is needed: the caller passes
numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

SEP = "/"

# The JAX package's kernel registry, under the port's names: impl names of
# every kind (``MaceConfig.impl`` / ``interaction_impl``), the interaction
# backward (``interaction_bwd_impl`` / ``InteractionSpec.bwd_impl``), the
# capability field that marks a hand-written kernel, and the platforms (the
# TPU kernels' counterparts run on the GPU).
JAX_IMPL_NAMES = {"ref": "ref", "fused": "fused", "pallas": "cuda",
                  "pallas_bf16": "cuda_bf16", "pallas_fp8": "cuda_fp8"}
JAX_BWD_IMPL_NAMES = {"pallas": "cuda", "xla": "fused"}
JAX_CAPABILITY_FIELDS = {"uses_pallas": "uses_kernel"}
JAX_PLATFORMS = {"cpu": "cpu", "gpu": "gpu", "tpu": "gpu"}
# the JAX package's execution engines (``TrainerConfig.engine``): its
# shard_map engine is the port's one-process-per-rank data-parallel engine
JAX_ENGINE_NAMES = {"sequential": "sequential", "shard_map": "data_parallel",
                    "multihost": "multihost"}


def tuning_record_from_jax(rec: Mapping[str, Any]) -> Dict[str, Any]:
    """A record of the JAX autotuner's files under the port's names: a
    trajectory row (``impl``, ``params["bwd_impl"]``), a trajectory run
    (``backend``, ``interpret_pallas``, its ``rows``), a tuning-table entry
    (``platform``, ``impl``, ``bwd_impl``) or a whole table (its
    ``entries``).  Other fields are copied as they are."""
    out = dict(rec)
    for key in ("rows", "entries"):
        if key in rec:
            out[key] = [tuning_record_from_jax(r) for r in rec[key]]
    for key in ("backend", "platform"):
        if key in rec:
            out[key] = JAX_PLATFORMS[rec[key]]
    if "interpret_pallas" in rec:
        out["interpret_kernels"] = out.pop("interpret_pallas")
    if "impl" in rec:
        out["impl"] = JAX_IMPL_NAMES.get(rec["impl"], rec["impl"])
    if rec.get("bwd_impl") is not None:
        out["bwd_impl"] = JAX_BWD_IMPL_NAMES[rec["bwd_impl"]]
    if "bwd_impl" in rec.get("params", {}):
        out["params"] = dict(rec["params"],
                             bwd_impl=JAX_BWD_IMPL_NAMES[rec["params"]["bwd_impl"]])
    return out


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {``a/b/c``: leaf}."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten(val, path))
        else:
            flat[path] = val
    return flat


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{``a/b/c``: leaf} -> nested dict."""
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX parameters as numpy (nested like ``init_mace``'s pytree, or flat
    with checkpoint path keys) -> the port's nested dict of float32 CPU
    tensors."""
    flat = flatten(tree)
    return unflatten(
        {k: torch.as_tensor(np.array(v, dtype=np.float32)) for k, v in flat.items()}
    )


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's parameters -> {checkpoint path: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in flatten(params).items()}


def params_to(params: Mapping[str, Any], device) -> Dict[str, Any]:
    """The same nested dict with every tensor moved to ``device``."""
    return unflatten({k: v.to(device) for k, v in flatten(params).items()})


def resolve_device(device: Optional[Any]) -> torch.device:
    """``None`` -> the CUDA card, and an error when there is none.  Every
    entry point of the port (serving and training) resolves its device
    here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
