"""Symmetric-contraction kernels (paper Algorithm 3) in kernel layout.

The CUDA kernels are ``csrc/symmetric_contraction.cu`` (``symcon_fwd``,
``symcon_bwd``); they replace the Pallas TPU kernels ``_symcon_kernel`` and
``_symcon_bwd_kernel`` of the JAX package's
``kernels/symmetric_contraction/kernel.py``.  A third kernel,
``csrc/symmetric_contraction_second.cu`` (``symcon_dbl``), is the backward's
own derivative, the second order that training's force loss asks for; it
replaces no TPU kernel (the JAX package leaves that derivative to XLA).
Like the TPU kernels, which unroll the CG groups at trace time, each source
is built once per (spec, precision) with a generated header
(:func:`spec_header`) that unrolls the groups of :func:`_group_entries` into
scalar sums over one (atom, channel)'s columns, in the cases of a switch
inside a loop that is not unrolled.
Beside each kernel is its plain PyTorch version over the same CG groups:

* :func:`symcon_plain` — port of the JAX ``symcon_xla_raw``;
* :func:`symcon_bwd_plain` — an explicit loop over the groups, the product
  rule of ``_symcon_bwd_kernel``;
* :func:`symcon_dbl_plain` — the same loop for the second order.

Precision (``"fp32"``, ``"bf16"``, ``"fp8"``; ``kernels/precision.py``):
the bf16 and fp8 builds round every loaded operand (A and W; G in the
backward) and compute in fp32, as the TPU kernels' ``precision`` argument
does; the plain versions round the same operands with ``round_to``.

The wrappers :func:`symcon_fwd`, :func:`symcon_bwd` and :func:`symcon_dbl`
launch the kernel on a CUDA tensor and take the plain version only for a
CPU tensor.  The second order is fp32 at every precision.

Layout: A [N, d_in, k], W [N, P_total, k] (species-gathered, terms
concatenated along the path axis), B [N, d_out, k]; k minor.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.core.symmetric_contraction import (
    SymConSpec,
    SymConTables,
    build_symcon_tables,
)
from repro_torch.kernels.cuda_lib import (
    INT,
    PTR,
    CudaKernel,
    f32_literal,
    precision_define,
)
from repro_torch.kernels.precision import round_to

SYMCON_FWD = CudaKernel(
    "symmetric_contraction.cu", "symcon_fwd", [PTR] * 3 + [INT] * 2
)
SYMCON_BWD = CudaKernel(
    "symmetric_contraction.cu", "symcon_bwd", [PTR] * 5 + [INT] * 2
)
SYMCON_DBL = CudaKernel(
    "symmetric_contraction_second.cu", "symcon_dbl", [PTR] * 8 + [INT] * 2
)
# round_op of a build on n values (a check of the rounding, off the model's path)
ROUND_VALUES = CudaKernel("symmetric_contraction.cu", "round_values", [PTR] * 2 + [INT])


def _group_entries(
    spec: SymConSpec, tables: SymConTables
) -> Tuple[List[Tuple[int, int, int, int, List[Tuple[Tuple[int, ...], float]]]], int]:
    """Flatten tables into per-(term, eta, M) entry groups.

    Returns (groups, P_total) where each group is
    (w_offset + eta, out_offset + M, nu, n_entries, [(idx_tuple, val), ...]).
    """
    groups = []
    w_off = 0
    for (L, nu, idx, M, eta, val) in tables.entries:
        out_off = spec.out_spec.slice_for(L).start
        n_paths = spec.n_paths(L, nu)
        buckets: Dict[Tuple[int, int], List[Tuple[Tuple[int, ...], float]]] = {}
        for e in range(len(val)):
            key = (int(eta[e]), int(M[e]))
            buckets.setdefault(key, []).append(
                (tuple(int(x) for x in idx[e]), float(val[e]))
            )
        for (et, m), ents in sorted(buckets.items()):
            groups.append((w_off + et, out_off + m, nu, len(ents), ents))
        w_off += n_paths
    return groups, w_off


@functools.lru_cache(maxsize=None)
def p_total_of(spec: SymConSpec) -> int:
    return _group_entries(spec, build_symcon_tables(spec))[1]


@functools.lru_cache(maxsize=None)
def spec_header(spec: SymConSpec, precision: str = "fp32") -> str:
    """The header the symmetric-contraction sources are built with for
    ``spec`` at ``precision``: the operand rounding (``PRECISION``), the
    spec's dimensions and three functions over one (atom, channel)'s
    columns, each a switch inside a loop that is not unrolled, whose cases
    hold the groups of :func:`_group_entries` in table order:

    * ``symcon_forward(A, W, B, k, ld)`` (:func:`_first_order_body`): per
      group ``s = / += Π a[m_x] * val`` over its entries, then ``b[out] +=
      w[eta] * s``;
    * ``symcon_backward(A, W, G, dA, dW, k, ld)``: per group the same ``s``
      and, per entry and position x, ``da[m_x] += g[out] w[eta] * (Π_{y != x}
      a[m_y] * val)``; ``dw[eta] = / += g[out] * s``;
    * ``symcon_second<PART>(A, W, G, U, V, dA, dW, dG, k)``, the second
      order (the VJP of the backward's map with cotangents U of dA and V of
      dW; :func:`_second_order_body`), one specialisation for each of the
      ``SECOND_ORDER_PARTS`` launches.

    ``ld`` is the source's load of one operand (``round_op`` of ``__ldg``);
    the second order loads fp32 itself."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    if any(nu > 3 for (_, _, nu, _, _) in groups):
        raise NotImplementedError("the CUDA symcon kernels take nu <= 3")
    d_in, d_out = spec.in_spec.dim, spec.out_spec.dim
    parts = second_order_parts(spec)
    fwd, bwd = _first_order_body(groups, p_total)
    return "\n".join([
        "// Generated by repro_torch/kernels/symmetric_contraction/kernel.py::spec_header",
        f"// for {spec!r}.",
        "#pragma once",
        precision_define(precision),
        f"constexpr int D_IN = {d_in}, P_TOTAL = {p_total}, D_OUT = {d_out};",
        f"constexpr int SECOND_ORDER_PARTS = {len(parts)};",
        "template <class Load>",
        "__device__ __forceinline__ void symcon_forward(",
        "    const float* __restrict__ A, const float* __restrict__ W,",
        "    float* __restrict__ B, long k, Load ld) {",
        *fwd,
        "}",
        "template <class Load>",
        "__device__ __forceinline__ void symcon_backward(",
        "    const float* __restrict__ A, const float* __restrict__ W,",
        "    const float* __restrict__ G, float* __restrict__ dA,",
        "    float* __restrict__ dW, long k, Load ld) {",
        *bwd,
        "}",
        "template <int PART>",
        "__device__ __forceinline__ void symcon_second(",
        "    const float* __restrict__ A, const float* __restrict__ W,",
        "    const float* __restrict__ G, const float* __restrict__ U,",
        "    const float* __restrict__ V, float* __restrict__ dA,",
        "    float* __restrict__ dW, float* __restrict__ dG, long k);",
        *_second_order_body(groups, p_total, parts)[0],
        "",
    ])


# most CG entries in one case of the first-order kernels' switch: consecutive
# groups share a case up to it, and a larger group is cut into balanced
# cases of at most it; the paper's spec (90 entries) is one case.  Cases of
# 48 and 96 spilled at a MACE-MP-0 spec, 192 at neither and ran fastest
# (PERF.md, Findings)
FIRST_ORDER_CASE_ENTRIES = 192
# most CG entries in one case of symcon_second's switch: at correlation 3
# a case of one whole group (up to 126 entries) spilled, and cases of 64
# took 10% longer than cases of 96 (PERF.md, Findings)
SECOND_ORDER_CASE_ENTRIES = 96
# most output rows one launch of the second order keeps live (its rows of
# G and the dG sums), unless one irrep alone has more: MACE-MP-0 large's 9
# rows in one launch spilled (PERF.md, Findings)
SECOND_ORDER_PART_ROWS = 4


def _cuts(n: int, most: int) -> List[Tuple[int, int]]:
    """``[0, n)`` in balanced consecutive pieces of at most ``most``."""
    pieces = -(-n // most)
    ends = [round(i * n / pieces) for i in range(pieces + 1)]
    return list(zip(ends, ends[1:]))


def _runs(groups):
    """Per group: (first, last) of its run of groups of one weight row."""
    return [(gi == 0 or groups[gi - 1][0] != g[0],
             gi == len(groups) - 1 or groups[gi + 1][0] != g[0])
            for gi, g in enumerate(groups)]


def _loop(n_cases: int, cases: List[str]) -> List[str]:
    return ["#pragma unroll 1",
            f"  for (int j = 0; j < {n_cases}; ++j) {{",
            "    switch (j) {",
            *cases,
            "    }",
            "  }"]


def _case(j: int, loads: List[str], lines: List[str]) -> List[str]:
    return [f"    case {j}: {{", *(f"      {x}" for x in loads + lines), "    } break;"]


def _first_order_body(groups, p_total: int) -> Tuple[List[str], List[str]]:
    """The statements of ``symcon_forward`` and ``symcon_backward``.

    Consecutive groups share a case up to ``FIRST_ORDER_CASE_ENTRIES``
    entries, and a larger group is cut into balanced cases; each case loads
    the rows of A it uses, and a weight row's w when its run of groups
    starts, except that a body of one case (the paper's spec) loads its
    weight rows with A, before any arithmetic, as the straight-line code
    did (loaded where each run starts, its forward took 7% longer at 256
    atoms; at MACE-MP-0 medium's 15 cases loading them with A took 10%
    longer: PERF.md, Findings).  b (forward), g and da (backward) stay in
    registers across
    cases, as do the running sum s, the group's g[out] w[eta] and the run's
    w and dw (stored when the run ends).  Every sum runs in table order:
    groups, entries, positions, as the plain versions sum.  Straight-line
    code over all entries spilled 2.7-2.8 KB a thread at MACE-MP-0 large's
    7,101 entries (PERF.md, Findings)."""
    pieces, cur, n = [], [], 0
    for gi, (*_, ents) in enumerate(groups):
        if len(ents) > FIRST_ORDER_CASE_ENTRIES or n + len(ents) > FIRST_ORDER_CASE_ENTRIES:
            if cur:
                pieces.append(cur)
            cur, n = [], 0
        if len(ents) > FIRST_ORDER_CASE_ENTRIES:
            pieces += [[(gi, c0, c1)] for c0, c1 in _cuts(len(ents), FIRST_ORDER_CASE_ENTRIES)]
        else:
            cur.append((gi, 0, len(ents)))
            n += len(ents)
    if cur:
        pieces.append(cur)
    runs = _runs(groups)
    hoist_w = len(pieces) == 1
    fwd_cases, bwd_cases = [], []
    for j, piece in enumerate(pieces):
        fwd, bwd, used, w_rows = [], [], set(), []
        for gi, c0, c1 in piece:
            w_idx, out_idx, nu, _, ents = groups[gi]
            first_of_run, last_of_run = runs[gi]
            if c0 == 0:
                if first_of_run:
                    w_rows.append(w_idx)
                    w = f"w{w_idx}" if hoist_w else f"ld(W + {w_idx} * k)"
                    fwd.append(f"wr = {w};")
                    bwd.append(f"wr = {w};")
                bwd.append(f"gw = g[{out_idx}] * wr;")
            for e in range(c0, c1):
                ix, val = ents[e]
                used.update(ix)
                c = f32_literal(val)
                s = f"s {'=' if e == 0 else '+='} {' * '.join([f'a{m}' for m in ix] + [c])};"
                fwd.append(s)
                bwd.append(s)
                for x in range(nu):
                    rest = [f"a{m}" for y, m in enumerate(ix) if y != x]
                    bwd.append(f"da[{ix[x]}] += gw * ({' * '.join(rest + [c])});" if rest
                               else f"da[{ix[x]}] += gw * {c};")
            if c1 == len(ents):
                fwd.append(f"b[{out_idx}] += wr * s;")
                bwd.append(f"dwr {'=' if first_of_run else '+='} g[{out_idx}] * s;")
                if last_of_run:
                    bwd.append(f"dW[{w_idx} * k] = dwr;")
        loads = ["const float " + ", ".join(f"a{m} = ld(A + {m} * k)" for m in sorted(used)) + ";"]
        if hoist_w and w_rows:
            loads.append("const float " + ", ".join(f"w{r} = ld(W + {r} * k)" for r in w_rows)
                         + ";")
        fwd_cases += _case(j, loads, fwd)
        bwd_cases += _case(j, loads, bwd)
    reached = {w_idx for (w_idx, *_rest) in groups}
    forward = [
        "  float b[D_OUT];",
        "  float s = 0.f, wr = 0.f;",
        "#pragma unroll",
        "  for (int m = 0; m < D_OUT; ++m) b[m] = 0.f;",
        *_loop(len(pieces), fwd_cases),
        "#pragma unroll",
        "  for (int m = 0; m < D_OUT; ++m) B[m * k] = b[m];",
    ]
    backward = [
        "  float g[D_OUT], da[D_IN];",
        "  float s = 0.f, wr = 0.f, gw = 0.f, dwr = 0.f;",
        "#pragma unroll",
        "  for (int m = 0; m < D_OUT; ++m) g[m] = ld(G + m * k);",
        "#pragma unroll",
        "  for (int m = 0; m < D_IN; ++m) da[m] = 0.f;",
        *(f"  dW[{r} * k] = 0.f;" for r in range(p_total) if r not in reached),
        *_loop(len(pieces), bwd_cases),
        "#pragma unroll",
        "  for (int m = 0; m < D_IN; ++m) dA[m * k] = da[m];",
    ]
    return forward, backward


def second_order_parts(spec: SymConSpec) -> List[Tuple[int, int]]:
    """The output rows ``[r0, r1)`` of each launch of the second order: runs
    of whole output irreps of at most ``SECOND_ORDER_PART_ROWS`` rows (an
    irrep with more alone)."""
    parts = []
    for _, sl in spec.out_spec.slices():
        if parts and sl.stop - parts[-1][0] <= SECOND_ORDER_PART_ROWS:
            parts[-1] = (parts[-1][0], sl.stop)
        else:
            parts.append((sl.start, sl.stop))
    return parts


def _prod(ix, pos) -> str:
    """``Π a[ix[x]]`` over the entry positions ``pos`` (ascending), from the
    entry's pair products ``pXY``."""
    if len(pos) == 1:
        return f"a{ix[pos[0]]}"
    if len(pos) == 2:
        return f"p{pos[0]}{pos[1]}"
    return f"p01 * a{ix[2]}"


def _dprod(ix, pos) -> str:
    """``Σ_y u[ix[y]] Π_{z != y} a[ix[z]]`` over the positions ``pos``: the
    product's derivative along ``u``."""
    terms = []
    for y in pos:
        rest = tuple(z for z in pos if z != y)
        terms.append(f"u{ix[y]} * {_prod(ix, rest)}" if rest else f"u{ix[y]}")
    return " + ".join(terms)


def _second_order_body(groups, p_total: int, parts) -> Tuple[List[str], int]:
    """The statements of ``symcon_second``, and the arithmetic operations
    they make per (atom, channel): each ``*``, `` + `` and ``+=`` of the
    statements that compute.  The backward maps (a, w, g) to
    ``dw[eta] = Σ_j g[M] s_j`` and ``da[m] = Σ_j g[M] w[eta] ∂s_j/∂a[m]``
    (``s_j = Σ val Π_x a[m_x]`` over group j's entries); its VJP with
    cotangents (u, v) is, per group, with ``ds_j = Σ val Σ_x u[m_x]
    Π_{y != x} a[m_y]``: ``dg[M] += w[eta] ds_j + v[eta] s_j``, ``dw[eta] +=
    g[M] ds_j`` and, per entry and position x, ``da[m_x] += val (g[M] w[eta]
    Σ_{y != x} u[m_y] Π_{z != x, y} a[m_z] + g[M] v[eta] Π_{y != x}
    a[m_y])``.  Groups in table order, entries in group order, positions in
    order; :func:`symcon_dbl_plain` sums in the same order.

    The entries are cut into the cases of a switch inside a loop that is
    not unrolled: each group's entries in balanced cases of at most
    ``SECOND_ORDER_CASE_ENTRIES``, in order.  Each case loads the rows of A
    and U it uses; g, da and dg stay in registers across cases, as do the
    running sums s, ds, the group's g[M] w[eta] and g[M] v[eta], and the run
    of groups of one weight row (its w, v and dw, stored when the run ends).
    Straight-line code over all entries spills at correlation 3: the
    compilers keep products of A shared by entries far apart live between
    them, and a case that reads A only from registers lets them hoist every
    product out of the loop.

    The groups of each part of ``parts`` (output rows ``[r0, r1)``; the
    tables hold the groups output irrep by irrep, so a part's groups are
    consecutive) are the specialisation ``symcon_second<p>``, launched on
    its own, in order, as a kernel of its own registers; it keeps only its
    rows of g and dg live, and a later part starts its da sums from the dA
    the one before stored, so each sum runs in table order across the
    launches as in one."""
    runs = _runs(groups)
    part_of = [next(p for p, (r0, r1) in enumerate(parts) if r0 <= out_idx < r1)
               for (_, out_idx, *_rest) in groups]
    assert part_of == sorted(part_of), "a part's groups must be consecutive"
    reached = {w_idx for (w_idx, *_rest) in groups}
    bodies, n_ops = [], 0
    for p, (r0, r1) in enumerate(parts):
        cases, n_cases = [], 0
        for gi, (w_idx, out_idx, nu, _, ents) in enumerate(groups):
            if part_of[gi] != p:
                continue
            first_of_run, last_of_run = runs[gi]
            o = out_idx - r0
            every = tuple(range(nu))
            for c0, c1 in _cuts(len(ents), SECOND_ORDER_CASE_ENTRIES):
                lines, math, used = [], [], set()
                if c0 == 0:
                    if first_of_run:
                        lines.append(f"wr = __ldg(W + {w_idx} * k); vr = __ldg(V + {w_idx} * k);")
                    math.append(f"gw = g[{o}] * wr; gv = g[{o}] * vr;")
                for e in range(c0, c1):
                    ix, val = ents[e]
                    used.update(ix)
                    c = f32_literal(val)
                    pairs = ", ".join(f"p{x}{y} = a{ix[x]} * a{ix[y]}"
                                      for x in every for y in every if x < y)
                    stmts = [f"const float {pairs};"] if pairs else []
                    op = "=" if e == 0 else "+="
                    stmts += [f"s {op} {_prod(ix, every)} * {c};",
                              f"ds {op} ({_dprod(ix, every)}) * {c};"]
                    for x in every:
                        rest = tuple(y for y in every if y != x)
                        stmts.append(f"da[{ix[x]}] += " + (
                            f"(gw * ({_dprod(ix, rest)}) + gv * {_prod(ix, rest)}) * {c};"
                            if rest else f"gv * {c};"))
                    math.append("{ " + " ".join(stmts) + " }")
                if c1 == len(ents):
                    math.append(f"dg[{o}] += wr * ds + vr * s;")
                    math.append(f"dwr {'=' if first_of_run else '+='} g[{o}] * ds;")
                n_ops += sum(line.count("*") + line.count(" + ") + line.count("+=")
                             for line in math)  # not the "+" of a literal's exponent
                lines += math
                if c1 == len(ents) and last_of_run:
                    lines.append(f"dW[{w_idx} * k] = dwr;")
                rows = sorted(used)
                cases += _case(n_cases, [
                    "const float " + ", ".join(f"a{m} = __ldg(A + {m} * k)" for m in rows) + ";",
                    "const float " + ", ".join(f"u{m} = __ldg(U + {m} * k)" for m in rows) + ";",
                ], lines)
                n_cases += 1
        rows_of = "D_OUT" if (r0, r1) == (0, parts[-1][1]) else str(r1 - r0)
        g_rows = "G" if r0 == 0 else f"(G + {r0} * k)"
        dg_rows = "dG" if r0 == 0 else f"(dG + {r0} * k)"
        bodies.append([
            f"  float g[{rows_of}], da[D_IN], dg[{rows_of}];",
            "  float s = 0.f, ds = 0.f, gw = 0.f, gv = 0.f, wr = 0.f, vr = 0.f, dwr = 0.f;",
            "#pragma unroll",
            f"  for (int m = 0; m < {rows_of}; ++m) "
            f"{{ g[m] = __ldg({g_rows} + m * k); dg[m] = 0.f; }}",
            "#pragma unroll",
            # a later part's sums go on from the ones the part before stored
            "  for (int m = 0; m < D_IN; ++m) da[m] = " + ("0.f;" if p == 0 else "dA[m * k];"),
            *(f"  dW[{r} * k] = 0.f;" for r in range(p_total) if r not in reached and p == 0),
            *_loop(n_cases, cases),
            "#pragma unroll",
            "  for (int m = 0; m < D_IN; ++m) dA[m * k] = da[m];",
            "#pragma unroll",
            f"  for (int m = 0; m < {rows_of}; ++m) {dg_rows}[m * k] = dg[m];",
        ])
    out = []
    for p, body in enumerate(bodies):
        out += ["template <>",
                f"__device__ __forceinline__ void symcon_second<{p}>(",
                "    const float* __restrict__ A, const float* __restrict__ W,",
                "    const float* __restrict__ G, const float* __restrict__ U,",
                "    const float* __restrict__ V, float* __restrict__ dA,",
                "    float* __restrict__ dW, float* __restrict__ dG, long k) {",
                *body, "}"]
    return out, n_ops


def second_order_ops(spec: SymConSpec) -> int:
    """Arithmetic operations of ``spec``'s second-order kernel per (atom,
    channel), as its generated ``symcon_second`` makes them."""
    return _second_order_body(*_group_entries(spec, build_symcon_tables(spec)),
                              second_order_parts(spec))[1]


def build_units(specs, precisions=("fp32",)):
    """The (source, header) build units of these specs' kernels at these
    precisions, for :func:`repro_torch.kernels.cuda_lib.build`."""
    return [("symmetric_contraction.cu", spec_header(spec, p))
            for spec in specs for p in precisions]


def second_order_unit(spec: SymConSpec):
    """The build unit of ``spec``'s second-order kernel (fp32 at every
    precision)."""
    return (SYMCON_DBL.source, spec_header(spec, "fp32"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def symcon_plain(A_t: torch.Tensor, W_t: torch.Tensor, spec: SymConSpec,
                 precision: str = "fp32") -> torch.Tensor:
    """Port of the JAX ``symcon_xla_raw``: B_t [N, d_out, k], from A and W
    rounded to ``precision``."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    assert W_t.shape[1] == p_total, (W_t.shape, p_total)
    A_t, W_t = round_to(A_t, precision), round_to(W_t, precision)
    N, _, k = A_t.shape
    cols = [None] * spec.out_spec.dim
    for (w_idx, out_idx, nu, _, ents) in groups:
        s = None
        for (idx, val) in ents:
            t = A_t[:, idx[0], :]
            for x in range(1, nu):
                t = t * A_t[:, idx[x], :]
            term = t * val
            s = term if s is None else s + term
        c = W_t[:, w_idx, :] * s
        cols[out_idx] = c if cols[out_idx] is None else cols[out_idx] + c
    zeros = A_t.new_zeros((N, k))
    return torch.stack([c if c is not None else zeros for c in cols], dim=1)


def symcon_bwd_plain(
    A_t: torch.Tensor, W_t: torch.Tensor, G_t: torch.Tensor, spec: SymConSpec,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dA_t [N, d_in, k], dW_t [N, P_total, k] by the product rule, group by
    group (the sweep of the TPU ``_symcon_bwd_kernel``), from A, W and G
    rounded to ``precision``."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    A_t, W_t, G_t = (round_to(t, precision) for t in (A_t, W_t, G_t))
    N, d_in, k = A_t.shape
    da = [None] * d_in
    dw = [None] * p_total

    def acc(buf, i, v):
        buf[i] = v if buf[i] is None else buf[i] + v

    for (w_idx, out_idx, nu, _, ents) in groups:
        g = G_t[:, out_idx, :]
        gw = g * W_t[:, w_idx, :]
        s = None
        for (idx, val) in ents:
            t = A_t[:, idx[0], :]
            for x in range(1, nu):
                t = t * A_t[:, idx[x], :]
            term = t * val
            s = term if s is None else s + term
            for x in range(nu):
                p = None
                for y in range(nu):
                    if y != x:
                        ay = A_t[:, idx[y], :]
                        p = ay if p is None else p * ay
                acc(da, idx[x], gw * val if p is None else gw * (p * val))
        acc(dw, w_idx, g * s)

    zeros = A_t.new_zeros((N, k))
    dA = torch.stack([zeros if c is None else c for c in da], dim=1)
    dW = torch.stack([zeros if c is None else c for c in dw], dim=1)
    return dA, dW


def symcon_dbl_plain(
    A_t: torch.Tensor, W_t: torch.Tensor, G_t: torch.Tensor, U_t: torch.Tensor,
    V_t: torch.Tensor, spec: SymConSpec,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dA_t, dW_t, dG_t): the VJP of :func:`symcon_bwd_plain`'s map
    ``(A, W, G) -> (dA, dW)`` with cotangents ``U_t`` of dA and ``V_t`` of
    dW, by the explicit product rule, group by group, in fp32 (the sums of
    ``_second_order_body``, in its order)."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    a, w, g, u, v = (t.unbind(1) for t in (A_t, W_t, G_t, U_t, V_t))
    da, dw, dg = [None] * len(a), [None] * p_total, [None] * len(g)

    def acc(buf, i, x):
        buf[i] = x if buf[i] is None else buf[i] + x

    def prod(ix, pairs, pos):  # as _prod
        if len(pos) == 1:
            return a[ix[pos[0]]]
        return pairs[pos] if len(pos) == 2 else pairs[(0, 1)] * a[ix[2]]

    def dprod(ix, pairs, pos):  # as _dprod
        out = None
        for y in pos:
            rest = tuple(z for z in pos if z != y)
            t = u[ix[y]] * prod(ix, pairs, rest) if rest else u[ix[y]]
            out = t if out is None else out + t
        return out

    for (w_idx, out_idx, nu, _, ents) in groups:
        gw, gv = g[out_idx] * w[w_idx], g[out_idx] * v[w_idx]
        every = tuple(range(nu))
        s = ds = None
        for (ix, val) in ents:
            pairs = {(x, y): a[ix[x]] * a[ix[y]] for x in every for y in every if x < y}
            term_s = prod(ix, pairs, every) * val
            term_ds = dprod(ix, pairs, every) * val
            s, ds = (term_s, term_ds) if s is None else (s + term_s, ds + term_ds)
            for x in every:
                rest = tuple(y for y in every if y != x)
                acc(da, ix[x], (gw * dprod(ix, pairs, rest) + gv * prod(ix, pairs, rest)) * val
                    if rest else gv * val)
        acc(dg, out_idx, w[w_idx] * ds + v[w_idx] * s)
        acc(dw, w_idx, g[out_idx] * ds)

    zeros = A_t.new_zeros((A_t.shape[0], A_t.shape[2]))
    return tuple(torch.stack([zeros if c is None else c for c in buf], dim=1)
                 for buf in (da, dw, dg))


# ---------------------------------------------------------------------------
# wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(A_t, W_t, spec):
    if A_t.dim() != 3:
        raise ValueError(f"A_t must be [N, d_in, k], got {tuple(A_t.shape)}")
    N, d_in, k = A_t.shape
    if d_in != spec.in_spec.dim:
        raise ValueError(f"A_t has d_in={d_in}, spec wants {spec.in_spec.dim}")
    _check("A_t", A_t, (N, d_in, k), A_t.device)
    _check("W_t", W_t, (N, p_total_of(spec), k), A_t.device)
    if A_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A_t.device}")
    return N, d_in, k


def symcon_fwd(A_t: torch.Tensor, W_t: torch.Tensor, spec: SymConSpec,
               precision: str = "fp32") -> torch.Tensor:
    """B_t [N, d_out, k]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    N, d_in, k = _check_inputs(A_t, W_t, spec)
    if not A_t.is_cuda:
        return symcon_plain(A_t, W_t, spec, precision)
    d_out = spec.out_spec.dim
    B_t = torch.empty((N, d_out, k), dtype=A_t.dtype, device=A_t.device)
    if B_t.numel() == 0:
        return B_t
    SYMCON_FWD(A_t.data_ptr(), W_t.data_ptr(), B_t.data_ptr(), N, k,
               header=spec_header(spec, precision))
    return B_t


def symcon_bwd(
    A_t: torch.Tensor, W_t: torch.Tensor, G_t: torch.Tensor, spec: SymConSpec,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dA_t, dW_t): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    N, d_in, k = _check_inputs(A_t, W_t, spec)
    d_out = spec.out_spec.dim
    _check("G_t", G_t, (N, d_out, k), A_t.device)
    if not A_t.is_cuda:
        return symcon_bwd_plain(A_t, W_t, G_t, spec, precision)
    dA = torch.empty_like(A_t)
    dW = torch.empty_like(W_t)
    if dA.numel() == 0:
        return dA, dW
    SYMCON_BWD(A_t.data_ptr(), W_t.data_ptr(), G_t.data_ptr(), dA.data_ptr(),
               dW.data_ptr(), N, k, header=spec_header(spec, precision))
    return dA, dW


def symcon_dbl(
    A_t: torch.Tensor, W_t: torch.Tensor, G_t: torch.Tensor, U_t: torch.Tensor,
    V_t: torch.Tensor, spec: SymConSpec,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dA_t, dW_t, dG_t), the second order of :func:`symcon_bwd` with
    cotangents ``U_t`` (dA's shape) and ``V_t`` (dW's): the CUDA kernel, fp32
    whatever the first order's precision, one launch per part of
    :func:`second_order_parts` (each counted), for CUDA tensors; the plain
    version for CPU tensors."""
    N, d_in, k = _check_inputs(A_t, W_t, spec)
    d_out = spec.out_spec.dim
    _check("G_t", G_t, (N, d_out, k), A_t.device)
    _check("U_t", U_t, A_t.shape, A_t.device)
    _check("V_t", V_t, W_t.shape, A_t.device)
    if not A_t.is_cuda:
        return symcon_dbl_plain(A_t, W_t, G_t, U_t, V_t, spec)
    dA, dW, dG = torch.empty_like(A_t), torch.empty_like(W_t), torch.empty_like(G_t)
    if dA.numel() == 0:
        return dA, dW, dG
    SYMCON_DBL(*(t.data_ptr() for t in (A_t, W_t, G_t, U_t, V_t, dA, dW, dG)), N, k,
               header=spec_header(spec, "fp32"), launches=len(second_order_parts(spec)))
    return dA, dW, dG


def round_on_card(x: torch.Tensor, spec: SymConSpec, precision: str) -> torch.Tensor:
    """``round_op`` of the ``(spec, precision)`` build on every element of
    the float32 CUDA tensor ``x``: the kernels' operand rounding, to hold
    against :func:`repro_torch.kernels.precision.round_to`."""
    if x.dtype != torch.float32 or not x.is_cuda or not x.is_contiguous():
        raise ValueError("round_on_card takes a contiguous float32 CUDA tensor")
    y = torch.empty_like(x)
    if x.numel():
        ROUND_VALUES(x.data_ptr(), y.data_ptr(), x.numel(),
                     header=spec_header(spec, precision))
    return y


def gather_weights(
    weights: Dict[str, torch.Tensor], species: torch.Tensor, spec: SymConSpec,
) -> torch.Tensor:
    """Per-atom weight gather + term concat: [N, k, P_total]."""
    parts = [
        weights[f"w_L{L}_nu{nu}"][species]  # [N, k, n_paths]
        for (L, nu, *_rest) in build_symcon_tables(spec).entries
    ]
    return torch.cat(parts, dim=-1)
