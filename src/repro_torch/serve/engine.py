"""Inference engine: one bound forward per bucket, on one device.

Port of the JAX package's ``serve/engine.py``.  PyTorch runs eagerly, so a
bucket's forward is ``mace_energy_forces`` bound to the bucket's static
graph count; nothing is compiled, and the JAX engine's ``compile_census``
has no counterpart here.  ``collate`` runs the numpy ``collate_bin`` (with
the ``blk_*`` edge blocking when the interaction impl consumes it) and moves
the arrays to the engine's device.

``device=None`` means CUDA: without a card the engine raises rather than
run on the CPU, unless the caller asks for ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.bridge import params_to, resolve_device
from repro_torch.core.mace import MaceConfig, mace_energy_forces
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.data.molecules import Molecule
from repro_torch.train.engine import interaction_consumes_blocking

from .buckets import bucket_key

__all__ = ["ServeEngine", "make_serve_engine", "resolve_device"]


class ServeEngine:
    """Forward-only engine over a fixed bucket ladder.

    * ``collate(mols, bucket)``  -> (device batch, {"block_s": s})
    * ``forward(batch, bucket)`` -> (energy [G], forces [N, 3]) on device
    * ``warmup()``               -> run every bucket once (dummy batch)
    * ``close()``                -> drop the bound forwards; idempotent
    """

    def __init__(
        self,
        mace_cfg: MaceConfig,
        params: Any,
        buckets: Sequence[BinShape],
        *,
        device: Optional[Any] = None,
    ):
        self.device = resolve_device(device)
        self.mace_cfg = mace_cfg
        self.buckets = tuple(buckets)
        self.params = params_to(params, self.device)
        self.with_blocking = interaction_consumes_blocking(mace_cfg)
        if self.with_blocking:
            for b in self.buckets:
                if b.block_n != mace_cfg.interaction_block_n:
                    raise ValueError(
                        f"bucket {bucket_key(b)} block_n={b.block_n} != "
                        f"interaction_block_n={mace_cfg.interaction_block_n}"
                    )
        self._fwd: Dict[str, Any] = {
            bucket_key(b): functools.partial(
                mace_energy_forces, self.params, mace_cfg,
                n_graphs=int(b.max_graphs),
            )
            for b in self.buckets
        }

    # ------------------------------ lifecycle ------------------------------

    def warmup(self) -> Dict[str, float]:
        """Run every bucket's forward on an empty (all-padding) batch: loads
        the kernels and the device tables before serving starts.  Returns
        per-bucket wall seconds."""
        out: Dict[str, float] = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            batch, _ = self.collate([], b)
            e, f = self.forward(batch, b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            out[bucket_key(b)] = time.perf_counter() - t0
        return out

    def close(self) -> None:
        self._fwd = {}

    @property
    def closed(self) -> bool:
        return not self._fwd

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # ------------------------------- compute -------------------------------

    def collate(
        self, mols: Sequence[Molecule], bucket: BinShape
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
        """Host-side: pad one packed bin to its bucket's static shape (plus
        the ``blk_*`` edge blocking when the kernel consumes it), then move
        it to the device.  Strict: serving never drops a trailing graph."""
        stats = {"block_s": 0.0}
        col = collate_bin(
            mols, bucket, strict=True,
            with_blocking=self.with_blocking, timings=stats,
        )
        return {k: torch.from_numpy(v).to(self.device) for k, v in col.items()}, stats

    def forward(
        self, batch: Dict[str, torch.Tensor], bucket: BinShape
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(energy [max_graphs], forces [max_nodes, 3]) for one batch."""
        if self.closed:
            raise RuntimeError("serve engine is closed (rebuilt away?)")
        return self._fwd[bucket_key(bucket)](batch=batch)


def make_serve_engine(
    mace_cfg: MaceConfig,
    params: Any,
    buckets: Sequence[BinShape],
    *,
    device: Optional[Any] = None,
) -> ServeEngine:
    """Engine factory (the fleet's rebuild entry point): construct and warm
    every bucket before the engine serves."""
    eng = ServeEngine(mace_cfg, params, buckets, device=device)
    eng.warmup()
    return eng
