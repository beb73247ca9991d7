"""Continuous-batching MACE graph serving on the port (torch + CUDA).

Port of the JAX package's ``serve`` package, in the same three layers:

**Queue** (``server.GraphServer.submit``): a bounded request queue of
variable-size molecular graphs; ``submit(mol)`` returns a future of a
:class:`~repro_torch.serve.server.ServeResult` (energy, forces, latency).

**Buckets** (``buckets``): a batcher thread packs request waves with
Algorithm 1 at the largest bucket's capacity and deals each bin into the
smallest fitting ``BinShape`` of a small fixed ladder.

**Workers** (``server`` fleet + ``engine.ServeEngine``): worker threads
collate packed bins (edge blocking included), run the bucket's forward on
the CUDA kernels, and route energies and forces back; a dead worker's bin
is requeued and ``drain_and_rebuild`` restarts the fleet with no request
dropped.
"""
from .buckets import (  # noqa: F401
    RequestTooLarge,
    bucket_key,
    bucket_ladder,
    pack_requests,
    select_bucket,
)
from .engine import ServeEngine, make_serve_engine, resolve_device  # noqa: F401
from .server import (  # noqa: F401
    GraphServer,
    RequestTimeout,
    ServeConfig,
    ServeResult,
    ServerClosed,
    ServerSaturated,
)

__all__ = [
    "GraphServer",
    "ServeConfig",
    "ServeResult",
    "ServeEngine",
    "ServerClosed",
    "ServerSaturated",
    "RequestTimeout",
    "RequestTooLarge",
    "bucket_ladder",
    "bucket_key",
    "pack_requests",
    "select_bucket",
    "make_serve_engine",
    "resolve_device",
]
