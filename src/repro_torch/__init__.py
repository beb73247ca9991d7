"""PyTorch + CUDA port of MACE serving and training (the JAX package
``repro`` stays beside it as the reference).

Mirrors ``repro``'s layout: ``core`` (irreps, CG tables, spherical
harmonics, radial basis, specs, the model and its loss), ``kernels`` (the
registry and the hand-written CUDA kernels with their plain PyTorch
versions), ``data`` (synthetic molecules, collation, edge blocking, the
samplers, prefetch), ``serve`` (bucket ladder, engine, server), ``train``
(optimizer, checkpoints, the sequential engine, the trainer), ``launch``
(the training driver) and ``bridge`` (parameters from and to the JAX
package, device placement).  Imports torch and numpy only, never ``jax``
or ``repro``.
"""
