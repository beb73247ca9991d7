"""Analytic FLOP / HBM-byte cells: one kernel call per (kind, impl), the
autotuner's ranking for shapes with no measured trajectory row
(``kernels.autotune``), one LM cell per (arch, shape) and the MACE
training cell of the dry run.

Port of ``kernel_cell_cost``, ``lm_cell_cost``, ``_avg_causal_kv`` and
``mace_cell_cost`` of the JAX package's ``roofline/analytic.py``, on the
port's own copies of the CG, tensor-product and symmetric-contraction
tables.  The
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


# --------------------------- LM cells ---------------------------------------
#
# The JAX model's conventions: matmul FLOPs = 2*M*N*K; training is 4x the
# forward with remat (forward, recompute, 2x backward), 3x without; prefill
# and decode are forward only; attention uses the exact causal / window
# average KV length.  HBM bytes: bf16 parameter copies streamed once per
# pass, the optimizer's fp32 read and write of params, m and v, residual
# stream traffic with a documented constant, KV caches read once per decode
# token (fused attention: no S^2 traffic).


def _avg_causal_kv(S: int, window) -> float:
    """mean over query positions t of min(t+1, window)."""
    if window is None or window >= S:
        return (S + 1) / 2.0
    W = window
    # positions 0..W-1 see t+1; the rest see W
    return (W * (W + 1) / 2.0 + (S - W) * W) / S


def lm_cell_cost(cfg, shape: Dict[str, Any]) -> Dict[str, float]:
    """FLOPs, HBM bytes and model FLOPs (6·N·D train, 2·N·D otherwise) of
    one LM cell: ``shape`` = {"kind": train|prefill|decode, "batch",
    "seq"}."""
    kind = shape["kind"]
    B, S = shape["batch"], shape["seq"]
    d, dh = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    cbytes = 2  # bf16 compute
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()

    T = B * S if kind in ("train", "prefill") else B
    mat_fwd = 2.0 * T * p_active

    # mixer extras per layer
    attn_fwd = mamba_fwd = mlstm_fwd = slstm_fwd = 0.0
    kv_bytes = 0.0
    n_attn = 0
    for i in range(cfg.n_layers):
        mixer, _ = cfg.layer_kinds(i)
        window = cfg.window if mixer == "swa" else None
        if mixer in ("attn", "swa"):
            n_attn += 1
            if kind == "decode":
                kv = min(S, window) if window else S
                attn_fwd += 4.0 * B * Hq * dh * kv
                kv_bytes += 2.0 * B * kv * Hkv * dh * cbytes  # read k+v
            else:
                kv_avg = _avg_causal_kv(S, window)
                attn_fwd += 4.0 * B * S * Hq * dh * kv_avg
                kv_bytes += 2.0 * B * S * Hkv * dh * cbytes   # write k+v
        elif mixer == "mamba":
            di = cfg.mamba_expand * d
            ds = cfg.mamba_d_state
            steps = S if kind != "decode" else 1
            mamba_fwd += B * steps * di * ds * 10.0 + 2.0 * B * steps * di * ds
        elif mixer == "mlstm":
            H = cfg.n_heads
            dhx = d // H
            c = min(256, S)
            steps = S if kind != "decode" else 1
            mlstm_fwd += B * H * steps * (4.0 * c * dhx + 4.0 * dhx * dhx)
        elif mixer == "slstm":
            H = cfg.n_heads
            dhx = d // H
            steps = S if kind != "decode" else 1
            slstm_fwd += B * steps * (8.0 * H * dhx * dhx + 20.0 * d)

    fwd = mat_fwd + attn_fwd + mamba_fwd + mlstm_fwd + slstm_fwd
    if kind == "train":
        factor = 4.0 if cfg.remat else 3.0
        flops = fwd * factor
    else:
        flops = fwd

    # HBM bytes
    if kind == "train":
        # fwd stream + bwd stream of bf16 param copies, fp32 opt update
        # (read p,m,v + write p,m,v), fp32 grads write+read
        param_traffic = p_total * (2 * cbytes + 6 * 4 + 2 * 4)
        act_traffic = 12.0 * T * d * cfg.n_layers * cbytes
        hbm = param_traffic + act_traffic + kv_bytes * 3
    elif kind == "prefill":
        hbm = p_total * cbytes + 8.0 * T * d * cfg.n_layers * cbytes + kv_bytes
    else:  # decode
        cache_read = kv_bytes  # full cache read per token
        hbm = p_total * cbytes + cache_read + 8.0 * B * d * cfg.n_layers * cbytes

    return {
        "flops": float(flops),
        "hbm_bytes": float(hbm),
        "model_flops": float(6.0 * T * p_active) if kind == "train" else float(2.0 * T * p_active),
        "tokens": float(T),
        "params_total": float(p_total),
        "params_active": float(p_active),
        "n_attn_layers": float(n_attn),
    }


# --------------------------- MACE --------------------------------------------


def mace_cell_cost(
    mace_cfg, n_bins: int, capacity: int, edge_factor: int,
    *, fused: bool = True, bf16: bool = False,
) -> Dict[str, float]:
    """Per-step cost for MACE training on ``n_bins`` bins (DP units).

    ``fused=False`` models the stock e3nn-style baseline (paper Observation
    3): dense CG/U einsums (no sparsity exploited) and every per-path /
    per-(L,nu) intermediate round-tripping HBM.  ``fused=True`` models the
    sparse-table kernel pipeline: compile-time nonzeros only, intermediates
    on chip (inputs read once, outputs written once).  ``bf16`` halves
    compute-byte traffic and runs at the bf16 peak.  The JAX package's
    arithmetic, float for float.
    """
    from repro_torch.core.cg import u_tensor
    from repro_torch.core.channelwise_tp import build_tp_tables
    from repro_torch.core.irreps import dim_l
    from repro_torch.core.symmetric_contraction import symcon_flops

    k = mace_cfg.channels
    N = n_bins * capacity
    E = n_bins * capacity * edge_factor
    cb = 2.0 if bf16 else 4.0   # compute bytes/elt

    fwd = 0.0
    traffic = 0.0
    for t in range(mace_cfg.n_interactions):
        tp = mace_cfg.tp_spec_at(t)
        tables = build_tp_tables(tp)
        if fused:
            fwd += E * k * len(tables.val) * 4.0       # sparse nnz
            fwd += E * k * tp.out_spec.dim * 2.0       # scatter(one-hot mm)
            # inputs read once, A written once (on-chip intermediates)
            traffic += (E * (tp.y_spec.dim + k * tp.h_spec.dim + k * tp.n_paths)
                        + N * k * tp.out_spec.dim) * cb
        else:
            # dense per-path einsum chain: C[d1,d2,d3] contracted densely,
            # each path's [E,k,d3] block round-trips HBM
            for (l1, l2, l3) in tp.paths:
                d1, d2, d3 = dim_l(l1), dim_l(l2), dim_l(l3)
                fwd += 2.0 * E * k * d1 * d2 * d3
                traffic += (E * k * (d2 + 2 * d3) + E * d1) * cb
            traffic += N * k * tp.out_spec.dim * cb    # scatter output
        # radial MLP (same either way)
        dims = (mace_cfg.num_bessel, *mace_cfg.radial_mlp, tp.n_paths * k)
        for a, b in zip(dims[:-1], dims[1:]):
            fwd += 2.0 * E * a * b
        traffic += E * dims[-1] * cb
        # per-l linears (up, A, msg)
        h_dim = mace_cfg.h_spec_at(t).dim
        fwd += 2.0 * N * k * k * (
            h_dim + mace_cfg.a_spec.dim + mace_cfg.hidden_spec.dim
        )
        traffic += 2.0 * N * k * (
            h_dim + mace_cfg.a_spec.dim + mace_cfg.hidden_spec.dim
        ) * cb
        # symmetric contraction
        sc = mace_cfg.symcon_spec()
        if fused:
            fwd += symcon_flops(sc, N, k)
            traffic += N * k * (sc.in_spec.dim + sc.out_spec.dim) * cb
        else:
            for (L, nu) in sc.terms():
                U = u_tensor(tuple(sc.in_spec.ls), L, nu)
                fwd += 2.0 * N * k * U.size            # dense U contract
                # each (L, nu) term's intermediates round-trip
                traffic += N * k * (
                    nu * sc.in_spec.dim + 2 * (2 * L + 1)
                ) * cb
        fwd += 2.0 * N * k * k  # skip connection
        traffic += N * k * 2 * cb
    fwd += 2.0 * N * k  # readouts (approx)

    # forces = grad wrt positions inside the loss -> roughly 7x fwd for a
    # full training step (fwd + force-grad graph + bwd through it)
    flops = fwd * 7.0
    traffic = traffic * 7.0

    params = 4.0 * (  # rough fp32 param bytes
        mace_cfg.n_species * k
        + mace_cfg.n_interactions * (3 * k * k * 4 + 64 * 64 * 3 + 2000 * k)
    )
    return {
        "flops": float(flops),
        "hbm_bytes": float(params * 9 + traffic),
        "model_flops": float(fwd * 7.0),
        "tokens": float(N),
        "params_total": float(params / 4.0),
        "params_active": float(params / 4.0),
        "n_attn_layers": 0.0,
    }
