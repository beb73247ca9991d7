"""Analytic FLOP / HBM-byte cells for ONE kernel call per (kind, impl): the
autotuner's ranking for shapes with no measured trajectory row
(``kernels.autotune``).

Port of ``kernel_cell_cost`` of the JAX package's ``roofline/analytic.py``
(its LM and whole-model cost models are not ported), on the port's own
copies of the CG, tensor-product and symmetric-contraction tables.  The
JAX impl ``pallas`` is the port's ``cuda`` (``bridge.JAX_IMPL_NAMES``), so
the kernel branch prices ``cuda`` the way the JAX one prices ``pallas``:

* ``ref``   dense per-path chains, every intermediate round-tripping HBM;
* ``fused`` compile-time-sparse compute, ``[E, k, nnz]``-ish intermediates
  written once and read once;
* ``cuda``  the same useful FLOPs with the intermediates on chip (inputs
  read once, outputs written once), at the cost of tile padding: the
  blocked interaction kernel computes on every edge SLOT (``T * block_e``),
  so the tile geometry shifts both terms and the model ranks geometries.

``mode="fwd_bwd"`` applies the JAX model's training factors (flops x3,
bytes x2.5).  The cells are a ranking signal, never a prediction: the
numbers are the JAX package's arithmetic, exactly.
"""
from __future__ import annotations

from typing import Any, Dict

_BWD_FLOP_FACTOR = 3.0
_BWD_BYTE_FACTOR = 2.5


def kernel_cell_cost(
    kind: str,
    impl: str,
    shape: Dict[str, Any],
    *,
    mode: str = "fwd",
    spec: Any = None,
) -> Dict[str, float]:
    """FLOPs + HBM bytes for one ``(kind, impl)`` call at ``shape``.

    ``shape`` carries the sizes the trajectory rows use: ``N`` and ``k``
    (+ ``nu``) for ``symcon``; ``E`` and ``k`` for ``channelwise_tp``;
    ``N``, ``E``, ``k`` (+ optional ``block_n``/``block_e``) for
    ``interaction``.  ``spec`` overrides the benchmark's spec
    (``SymConSpec`` / ``TPSpec``)."""
    from repro_torch.core.cg import u_tensor
    from repro_torch.core.channelwise_tp import TPSpec, build_tp_tables
    from repro_torch.core.irreps import dim_l, lspec, sh_spec
    from repro_torch.core.symmetric_contraction import SymConSpec, symcon_flops
    from repro_torch.data.blocking import DEFAULT_BLOCK_E, DEFAULT_BLOCK_N, static_n_tiles

    cb = 4.0  # fp32 compute bytes/elt
    k = int(shape["k"])

    if kind == "symcon":
        N = int(shape["N"])
        nu = int(shape.get("nu", 2))
        sc = spec if spec is not None else SymConSpec(lspec(0, 1, 2, 3), lspec(0, 1), nu)
        d_in, d_out = sc.in_spec.dim, sc.out_spec.dim
        io = N * k * (d_in + d_out) * cb
        if impl == "ref":
            flops = traffic = 0.0
            for (L, nu_t) in sc.terms():
                U = u_tensor(tuple(sc.in_spec.ls), L, nu_t)
                flops += 2.0 * N * k * U.size
                traffic += N * k * (nu_t * d_in + 2 * (2 * L + 1)) * cb
            bytes_ = io + traffic
        else:
            flops = float(symcon_flops(sc, N, k))
            # fused: the [N, k, nnz]-ish intermediates round-trip once; the
            # kernel keeps them on chip
            bytes_ = io * (2.0 if impl != "cuda" else 1.0)
    elif kind == "channelwise_tp":
        E = int(shape["E"])
        tp = spec if spec is not None else TPSpec(sh_spec(3), lspec(0, 1), lspec(0, 1, 2, 3))
        io = E * (tp.y_spec.dim + k * tp.h_spec.dim + k * tp.n_paths
                  + k * tp.out_spec.dim) * cb
        if impl == "ref":
            flops = bytes_ = 0.0
            for (l1, l2, l3) in tp.paths:
                d1, d2, d3 = dim_l(l1), dim_l(l2), dim_l(l3)
                flops += 2.0 * E * k * d1 * d2 * d3
                bytes_ += (E * k * (d2 + 2 * d3) + E * d1) * cb
            bytes_ += io
        else:
            nnz = len(build_tp_tables(tp).val)
            flops = E * k * (4.0 * nnz + 2.0 * tp.out_spec.dim)
            contrib_rt = E * k * nnz * cb  # [E, k, nnz] written + read
            bytes_ = io + (2.0 * contrib_rt if impl != "cuda" else 0.0)
    elif kind == "interaction":
        E, N = int(shape["E"]), int(shape["N"])
        tp = spec if spec is not None else TPSpec(sh_spec(3), lspec(0, 1), lspec(0, 1, 2, 3))
        d_out = tp.out_spec.dim
        inputs = E * (tp.y_spec.dim + k * tp.h_spec.dim + k * tp.n_paths) * cb
        out_bytes = N * k * d_out * cb
        if impl == "ref":
            cell = kernel_cell_cost("channelwise_tp", "ref", {"E": E, "k": k}, spec=tp)
            # dense TP + the [E, k, d_out] message tensor round trip + scatter
            flops = cell["flops"] + 2.0 * E * k * d_out
            bytes_ = cell["hbm_bytes"] + 2.0 * E * k * d_out * cb + out_bytes
        elif impl == "fused":
            nnz = len(build_tp_tables(tp).val)
            # nnz-basis aggregation: contrib round-trips, projection at N rows
            flops = 4.0 * E * k * nnz + 2.0 * N * k * nnz * d_out
            bytes_ = inputs + 2.0 * E * k * nnz * cb + N * k * nnz * cb + out_bytes
        else:  # the blocked kernel: computes on every edge SLOT
            bn = int(shape.get("block_n") or DEFAULT_BLOCK_N)
            be = int(shape.get("block_e") or DEFAULT_BLOCK_E)
            nnz = len(build_tp_tables(tp).val)
            T = static_n_tiles(E, N, bn, be)
            slots = float(T * be)
            flops = 4.0 * slots * k * nnz + 2.0 * slots * k * d_out
            # the gather feeding each tile reads edge inputs PER SLOT
            # (padding slots included: this is what penalizes geometries
            # with many half-empty tiles), plus one [block_n, d_out, k] row
            # block written per tile and the segment-add into atom rows
            per_slot = (tp.y_spec.dim + k * tp.h_spec.dim + k * tp.n_paths) * cb
            bytes_ = slots * per_slot + T * bn * k * d_out * cb + out_bytes
    else:
        raise KeyError(f"unknown kernel kind {kind!r}")

    if mode == "fwd_bwd":
        flops *= _BWD_FLOP_FACTOR
        bytes_ *= _BWD_BYTE_FACTOR
    elif mode != "fwd":
        raise ValueError(f"mode must be 'fwd' or 'fwd_bwd', got {mode!r}")
    return {"flops": float(flops), "hbm_bytes": float(bytes_)}
