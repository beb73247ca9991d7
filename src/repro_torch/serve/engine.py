"""Inference engine: one captured CUDA graph per bucket, on one device.

Port of the JAX package's ``serve/engine.py``, which jits one
``mace_energy_forces`` per bucket and proves with ``compile_census`` that
serving compiles nothing after warm-up.  Here the counterpart of an XLA
program compiled for one static shape is a ``torch.cuda.CUDAGraph``
captured for one bucket: the whole ``mace_energy_forces`` call (the
forward, ``torch.autograd.grad`` for the forces, every kernel) over static
input buffers, one per ``collate_bin`` array (``blk_*`` included), into
static outputs.  ``forward`` copies a batch into the buffers and replays the
graph; a batch whose arrays differ from the buffers in shape or dtype
raises, and never triggers a second capture or an eager run.

``warmup`` runs every bucket once eagerly on the engine's side stream (it
builds and loads the kernels and sets up autograd and cuBLAS, as the
PyTorch CUDA-graphs documentation requires before a capture), then
captures each bucket into a memory pool of its own: buckets replay in any
order, so they cannot share one.  A failed capture or replay raises; there
is no eager fallback.  Capture runs in ``thread_local`` error mode, so a
thread that is not capturing (a serving worker that outlived its fleet's
join, still copying a result to the host) cannot invalidate it; such a
thread's work on its own stream is not captured, since capture follows the
capturing stream.

On the CPU (``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version) the engine stays eager over the same static buffers and
captures nothing: its census is 0 per bucket.

``device=None`` means CUDA: without a card the engine raises rather than
run on the CPU, unless the caller asks for ``device="cpu"``.

An ``"auto"`` impl resolves from the tuning table before anything is
captured (:func:`resolve_serve_config`, the ``fwd_bwd`` rows at the
largest bucket, since forces are a positions-gradient), with the tile
search pinned to the ladder's geometry: the buckets' blocking is fixed
here.  ``GraphServer`` resolves before it builds its ladder and adopts the
decision's geometry instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.bridge import params_to, resolve_device
from repro_torch.core.mace import MaceConfig, mace_energy_forces
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.data.molecules import Molecule
from repro_torch.kernels import autotune, cuda_lib
from repro_torch.train.engine import interaction_consumes_blocking

from .buckets import bucket_key

__all__ = ["ServeEngine", "make_serve_engine", "resolve_device", "resolve_serve_config"]


def resolve_serve_config(
    mace_cfg: MaceConfig,
    *,
    capacity: int,
    edge_factor: int,
    platform: str,
    block_candidates: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[MaceConfig, Dict[str, autotune.Decision]]:
    """Resolve ``"auto"`` impl sentinels for the serving shape bucket.

    ``capacity`` is the *largest* bucket's atom budget (the shape the hot
    path runs at its most); forces are a positions-gradient, so the
    ``fwd_bwd`` tuning rows are the evidence.  A config without ``"auto"``
    comes back unchanged, with no decisions."""
    return autotune.resolve_mace_config(
        mace_cfg, capacity=capacity, edge_factor=edge_factor, platform=platform,
        mode="fwd_bwd", block_candidates=block_candidates,
    )


@dataclasses.dataclass
class _BucketProgram:
    """One bucket's static buffers and, on the card, its captured graph."""

    bucket: BinShape
    inputs: Dict[str, torch.Tensor]          # one per collate_bin array
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    launches: cuda_lib.LaunchTally = dataclasses.field(default_factory=dict)
    captures: int = 0
    pool_bytes: int = 0                       # device memory the capture reserved


class ServeEngine:
    """Forward-only engine over a fixed bucket ladder.

    * ``collate(mols, bucket)``  -> (device batch, {"block_s": s})
    * ``forward(batch, bucket)`` -> (energy [G], forces [N, 3]) on device:
      the bucket's static outputs, overwritten by its next forward (callers
      that share the engine between threads hold a lock per bucket)
    * ``warmup()``               -> run every bucket once, then capture it
    * ``compile_census()``       -> {bucket_key: graphs captured}
    * ``close()``                -> release the graphs and pools; idempotent
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
        mace_cfg, _ = resolve_serve_config(
            mace_cfg, capacity=max(b.max_nodes for b in buckets),
            edge_factor=max(b.max_edges // b.max_nodes for b in buckets),
            platform=autotune.platform_of(self.device),
            block_candidates=[(buckets[0].block_n, buckets[0].block_e)],
        )
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
        self._programs: Dict[str, _BucketProgram] = {
            bucket_key(b): _BucketProgram(b, self.collate([], b)[0])
            for b in self.buckets
        }
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------ lifecycle ------------------------------

    def warmup(self) -> Dict[str, float]:
        """Run every bucket's forward once on its (all-padding) buffers,
        then, on the card, capture it.  Returns per-bucket wall seconds."""
        out: Dict[str, float] = {}
        for key, prog in self._programs.items():
            t0 = time.perf_counter()
            if self._stream is None:
                self._eager(prog)
            else:
                self._capture(prog)
            out[key] = time.perf_counter() - t0
        return out

    def _eager(self, prog: _BucketProgram) -> Tuple[torch.Tensor, torch.Tensor]:
        return mace_energy_forces(self.params, self.mace_cfg, prog.inputs,
                                  int(prog.bucket.max_graphs))

    def _capture(self, prog: _BucketProgram) -> None:
        if prog.graph is not None:
            raise RuntimeError(f"bucket {bucket_key(prog.bucket)} is already captured")
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._eager(prog)
        torch.cuda.synchronize(self.device)
        # free the eager run's cached blocks first, so that what the capture
        # reserves is the pool alone
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with cuda_lib.recording_launches(stream) as tally:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                                  stream=stream, capture_error_mode="thread_local"):
                outputs = self._eager(prog)
        torch.cuda.synchronize(self.device)
        prog.graph, prog.outputs, prog.launches = graph, outputs, dict(tally)
        prog.captures += 1
        prog.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def close(self) -> None:
        """Release every bucket's graph and drop its buffers, then return the
        freed pools to the device."""
        for prog in self._programs.values():
            if prog.graph is not None:
                prog.graph.reset()
            prog.graph = prog.outputs = None
        self._programs = {}
        if self._stream is not None:
            torch.cuda.empty_cache()

    @property
    def closed(self) -> bool:
        return not self._programs

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

    def _program(self, bucket: BinShape) -> _BucketProgram:
        if self.closed:
            raise RuntimeError("serve engine is closed (rebuilt away?)")
        key = bucket_key(bucket)
        prog = self._programs.get(key)
        if prog is None:
            raise ValueError(f"{key} is not a bucket of this engine")
        return prog

    def forward(
        self, batch: Dict[str, torch.Tensor], bucket: BinShape
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(energy [max_graphs], forces [max_nodes, 3]) for one batch: its
        arrays copied into the bucket's buffers, then the bucket's graph
        replayed (on the CPU: the eager forward over the buffers)."""
        prog = self._program(bucket)
        key = bucket_key(bucket)
        if batch.keys() != prog.inputs.keys():
            raise ValueError(
                f"bucket {key}: batch arrays {sorted(batch)} differ from the "
                f"bucket's {sorted(prog.inputs)}"
            )
        for name, buf in prog.inputs.items():
            got = batch[name]
            if got.shape != buf.shape or got.dtype != buf.dtype:
                raise ValueError(
                    f"bucket {key}: array {name!r} is {got.dtype} "
                    f"{tuple(got.shape)}, the bucket's buffer {buf.dtype} "
                    f"{tuple(buf.shape)}"
                )
        for name, buf in prog.inputs.items():
            buf.copy_(batch[name])
        if self._stream is None:
            return self._eager(prog)
        if prog.graph is None:
            raise RuntimeError(f"bucket {key} has no captured graph: call warmup()")
        prog.graph.replay()
        cuda_lib.count_replay(prog.launches)
        return prog.outputs

    # ------------------------------ telemetry ------------------------------

    def compile_census(self) -> Dict[str, int]:
        """Graphs captured per bucket.

        The bucket-stability contract of the JAX engine: after
        :meth:`warmup` every entry is exactly 1 on the card, whatever mix
        was served, since a batch of another shape raises instead of being
        captured; 0 on the CPU, which captures nothing.  Empty once
        closed."""
        return {key: prog.captures for key, prog in self._programs.items()}

    def pool_bytes(self) -> Dict[str, int]:
        """Device memory each bucket's graph pool reserved at capture."""
        return {key: prog.pool_bytes for key, prog in self._programs.items()}


def make_serve_engine(
    mace_cfg: MaceConfig,
    params: Any,
    buckets: Sequence[BinShape],
    *,
    device: Optional[Any] = None,
) -> ServeEngine:
    """Engine factory (the fleet's rebuild entry point): construct and warm
    (on the card: capture) every bucket before the engine serves."""
    eng = ServeEngine(mace_cfg, params, buckets, device=device)
    eng.warmup()
    return eng
