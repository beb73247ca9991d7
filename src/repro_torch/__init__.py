"""PyTorch + CUDA port of the MACE serving path (the JAX package ``repro``
stays beside it as the reference).

Mirrors ``repro``'s layout: ``core`` (irreps, CG tables, spherical
harmonics, radial basis, specs, the model), ``kernels`` (the registry and
the hand-written CUDA kernels with their plain PyTorch versions), ``data``
(synthetic molecules, collation, edge blocking), ``serve`` (bucket ladder,
engine, server) and ``bridge`` (parameters from and to the JAX package).
Imports torch and numpy only, never ``jax`` or ``repro``.
"""
