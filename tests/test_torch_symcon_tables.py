"""The header the symmetric-contraction kernels are built from
(``spec_header``), read back statement by statement: each function's loop
runs the CG groups' entries in table order with their float32 values, each
group's sum feeds its row of b (of dw, and the product-rule terms of da),
every entry is used once per sum, and a weight row is loaded when its run
of groups starts and its dw stored when the run ends.  The parsed
statements, evaluated with numpy in float32 on random A, W, G, agree with
the plain versions ``symcon_plain`` and ``symcon_bwd_plain``.

Both sources, with the same header, are built for the host by g++ (the
CUDA names stubbed, the grid run as a loop, the second order's launches in
turn) and held to the plain versions.

Runs on the CPU.  Specs: the paper's; nu_max 1 (no entry reaches the
l = 2, 3 rows of A in the backward); nu_max 3 on A irreps 0+1+2 (33 groups,
523 entries); A irreps 0+1 -> B irreps 0+2 at nu_max 1, whose output rows
1-5 no group reaches; MACE-MP-0 large's (7,101 entries, 9 output rows, so
the second order in two launches).
"""
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.mace_cfm import CONFIG
from repro_torch.core.irreps import lspec
from repro_torch.core.symmetric_contraction import SymConSpec, build_symcon_tables
from repro_torch.kernels.symmetric_contraction import kernel as sck

SPECS = {
    "paper": CONFIG.symcon_spec(),
    "nu1": SymConSpec(lspec(0, 1, 2, 3), lspec(0, 1), 1),
    "nu3_in012": SymConSpec(lspec(0, 1, 2), lspec(0, 1), 3),
    "in01_out02_nu1": SymConSpec(lspec(0, 1), lspec(0, 2), 1),
    "mp0_large": SymConSpec(lspec(0, 1, 2, 3), lspec(0, 1, 2), 3),
}
HEX = r"-?0x[0-9a-f.]+p[+-]\d+f"
STMT = re.compile(r"^(?:const float )?(\w+)(?:\[(\d+)(?: \* k)?\])? (\+?=) (.+);$")
W_LOAD = re.compile(r"w(\d+) = ld\(W \+ (\d+) \* k\)")
# a weight row in an expression: loaded with A (a body of one case) or where
# its run of groups starts
W_ROW = re.compile(r"w(\d+)|ld\(W \+ (\d+) \* k\)")


def _groups(spec):
    return sck._group_entries(spec, build_symcon_tables(spec))[0]


def _runs(groups):
    """(first, last) of each group's run of groups of one weight row; each
    weight row is one run."""
    rows = [w for (w, *_rest) in groups]
    runs = [(i == 0 or rows[i - 1] != w, i == len(rows) - 1 or rows[i + 1] != w)
            for i, w in enumerate(rows)]
    assert sum(first for first, _ in runs) == len(set(rows))
    return runs


def _f32(v):
    return float(np.float32(v))


def _lines(header, fn):
    """The lines of one of the header's functions."""
    lines = header.splitlines()
    start = next(i for i, l in enumerate(lines) if f" {fn}(" in l)
    start = next(i for i in range(start, len(lines)) if lines[i].endswith("{")) + 1
    return lines[start:lines.index("}", start)]


def _body(header, fn):
    """The statements ``(target, row or None, op, expression)`` of one of the
    header's first-order functions in the order they run: its loop's cases
    in order, without each case's loads of A and W, which come before its
    arithmetic; a ``wr = wN`` reads a row ``wN = ld(W + N * k)`` its case
    loaded (a body of one case), a ``wr = ld(W + N * k)`` loads it where
    its run starts."""
    out, loaded = [], set()
    for line in _lines(header, fn):
        t = line.strip()
        if t.startswith("case "):
            loaded, started = set(), False
        elif t.startswith("const float w"):
            assert not started, line
            for w, row in W_LOAD.findall(t):
                assert w == row, line
                loaded.add(f"w{w}")
        elif not t.startswith(("} break;", "const float a")) and line.startswith("      "):
            m = STMT.match(t)
            assert m, line
            target, row, op, expr = m.groups()
            if target == "wr" and not expr.startswith("ld("):
                assert expr in loaded, line
            started = True
            out.append((target, None if row is None else int(row), op, expr))
    return out


def _product(expr):
    """``a3 * a5 * VAL`` -> ((3, 5), VAL)."""
    m = re.fullmatch(rf"((?:a\d+ \* )*)({HEX})", expr)
    assert m, expr
    return tuple(int(i) for i in re.findall(r"a(\d+)", m.group(1))), \
        float.fromhex(m.group(2)[:-1])


def _want_entries(ents):
    return [(tuple(ix), _f32(v)) for ix, v in ents]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_unrolls_the_groups_in_table_order(name):
    """symcon_forward: per group, in table order, ``s`` over exactly its
    entries, then ``b[out] += wr * s``, ``wr`` set to the group's weight
    row when its run of groups starts (the row loaded at the top of that
    case); every b row starts at 0 and
    is stored, so a row no group reaches is stored as 0."""
    spec = SPECS[name]
    groups = _groups(spec)
    header = sck.spec_header(spec)
    stmts, i, wr = _body(header, "symcon_forward"), 0, None
    for (w_idx, out_idx, nu, n, want), (first, _) in zip(groups, _runs(groups)):
        if first:
            assert stmts[i][:3] == ("wr", None, "=")
            wr = int(W_ROW.fullmatch(stmts[i][3]).group(1) or
                     W_ROW.fullmatch(stmts[i][3]).group(2))
            i += 1
        ents = []
        for target, row, op, expr in stmts[i:i + n]:
            assert (target, row, op) == ("s", None, "=" if not ents else "+=")
            ents.append(_product(expr))
        i += n
        assert ents == _want_entries(want)
        assert all(len(ix) == nu for ix, _ in ents)
        assert (stmts[i], wr) == (("b", out_idx, "+=", "wr * s"), w_idx)
        i += 1
    assert i == len(stmts)
    lines = [l.strip() for l in _lines(header, "symcon_forward")]
    assert "for (int m = 0; m < D_OUT; ++m) b[m] = 0.f;" in lines
    assert lines[-1] == "for (int m = 0; m < D_OUT; ++m) B[m * k] = b[m];"
    unreached = sorted(set(range(spec.out_spec.dim)) - {g[1] for g in groups})
    if name == "in01_out02_nu1":
        assert unreached == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_backward_unrolls_the_groups_and_the_product_rule(name):
    """symcon_backward: per group ``wr`` set to its weight row (loaded at
    the top of the case) when its run starts, ``gw =
    g[out] * wr``; per entry ``s = / +=`` its product, then for each
    position x ``da[m_x] += gw * (Π_{y != x} a[m_y] * VAL)``; ``dwr = / +=
    g[out] * s``, stored to its dW row when the run ends; a weight row no
    group reaches is zeroed, and every da row starts at 0 and is stored."""
    spec = SPECS[name]
    groups = _groups(spec)
    header = sck.spec_header(spec)
    stmts, i = _body(header, "symcon_backward"), 0
    for (w_idx, out_idx, nu, n, want), (first, last) in zip(groups, _runs(groups)):
        if first:
            assert stmts[i] in {("wr", None, "=", f"w{w_idx}"),
                                ("wr", None, "=", f"ld(W + {w_idx} * k)")}
            i += 1
        assert stmts[i] == ("gw", None, "=", f"g[{out_idx}] * wr")
        i += 1
        for e, (ix, v) in enumerate(want):
            assert stmts[i][:3] == ("s", None, "=" if e == 0 else "+=")
            assert _product(stmts[i][3]) == (tuple(ix), _f32(v))
            i += 1
            for x in range(nu):
                target, row, op, expr = stmts[i]
                assert (target, row, op) == ("da", ix[x], "+=")
                rest = tuple(m for y, m in enumerate(ix) if y != x)
                inner = re.fullmatch(r"gw \* \((.+)\)" if rest else r"gw \* (.+)", expr).group(1)
                assert _product(inner) == (rest, _f32(v))
                i += 1
        assert stmts[i] == ("dwr", None, "=" if first else "+=", f"g[{out_idx}] * s")
        i += 1
        if last:
            assert stmts[i] == ("dW", w_idx, "=", "dwr")
            i += 1
    assert i == len(stmts)
    lines = [l.strip() for l in _lines(header, "symcon_backward")]
    reached = {g[0] for g in groups}
    zeros = [l for l in lines if l.startswith("dW[") and l.endswith("= 0.f;")]
    assert zeros == [f"dW[{r} * k] = 0.f;" for r in range(sck.p_total_of(spec))
                     if r not in reached]
    assert "for (int m = 0; m < D_IN; ++m) da[m] = 0.f;" in lines
    assert lines[-1] == "for (int m = 0; m < D_IN; ++m) dA[m * k] = da[m];"
    held = {m for (_, _, _, _, want) in groups for ix, _ in want for m in ix}
    unheld = [m for m in range(spec.in_spec.dim) if m not in held]
    if name == "nu1":  # only the l = 0, 1 rows of A enter a nu = 1 term
        assert unheld == list(range(4, 16))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_every_entry_is_used_once_per_sum(name):
    spec = SPECS[name]
    header = sck.spec_header(spec)
    groups = _groups(spec)
    n_ent = sum(n for (_, _, _, n, _) in groups)
    n_terms = sum(nu * n for (_, _, nu, n, _) in groups)
    assert (f"constexpr int D_IN = {spec.in_spec.dim}, P_TOTAL = {sck.p_total_of(spec)}, "
            f"D_OUT = {spec.out_spec.dim};") in header
    for fn in ("symcon_forward", "symcon_backward"):
        assert sum(t == "s" for t, *_ in _body(header, fn)) == n_ent, fn
    assert sum(t == "da" for t, *_ in _body(header, "symcon_backward")) == n_terms
    if name == "nu3_in012":
        assert (len(groups), n_ent) == (33, 523)
    if name == "mp0_large":
        assert (len(groups), n_ent) == (161, 7101)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cases_hold_at_most_the_case_entries_and_load_what_they_use(name):
    """The first-order loop: each case holds at most
    ``FIRST_ORDER_CASE_ENTRIES`` entries (the paper's spec is one case) and
    loads exactly the rows of A its entries use."""
    lines = [l.strip() for l in _lines(sck.spec_header(SPECS[name]), "symcon_backward")]
    cases, cur = [], None
    for t in lines:
        if t.startswith("case "):
            cur = {"loads": set(), "used": set(), "entries": 0}
        elif t.startswith("const float a"):
            cur["loads"] = {int(m) for m in re.findall(r"a(\d+) = ld\(A \+ \1 \* k\)", t)}
        elif t == "} break;":
            cases.append(cur)
        elif cur is not None and t.startswith("s "):
            cur["entries"] += 1
            cur["used"].update(int(m) for m in re.findall(r"\ba(\d+)\b", t))
    assert cases and all(c["loads"] == c["used"] for c in cases)
    assert max(c["entries"] for c in cases) <= sck.FIRST_ORDER_CASE_ENTRIES
    if name == "paper":  # one case, which loads every weight row with A
        assert len(cases) == 1
        w_loads = [t for t in lines if t.startswith("const float w")]
        assert [W_LOAD.findall(t) for t in w_loads] == [
            [(str(r), str(r)) for r in sorted({g[0] for g in _groups(SPECS[name])})]]


def _evaluate(stmts, env):
    """Run parsed statements on float32 numpy arrays (each operand a list of
    [N, k] rows, ``a<m>`` the rows of A); return the environment."""
    def f32(m):
        return f"np.float32({float.fromhex(m.group(0)[:-1])!r})"

    for target, row, op, expr in stmts:
        expr = re.sub(r"\bw(\d+)\b|ld\(W \+ (\d+) \* k\)",
                      lambda m: f"w[{m.group(1) or m.group(2)}]", re.sub(HEX, f32, expr))
        value = np.broadcast_to(np.asarray(eval(  # noqa: S307 (generated text)
            expr, {"np": np}, env), np.float32), env["shape"])
        if row is None:
            env[target] = value if op == "=" else env[target] + value
        else:
            env[target][row] = value if op == "=" else env[target][row] + value
    return env


@pytest.mark.parametrize("name", sorted(SPECS))
def test_parsed_header_matches_the_plain_versions(name):
    spec = SPECS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    N, k = 5, 7
    p_total, d_in, d_out = sck.p_total_of(spec), spec.in_spec.dim, spec.out_spec.dim
    A = rng.standard_normal((N, d_in, k), dtype=np.float32)
    W = rng.standard_normal((N, p_total, k), dtype=np.float32)
    G = rng.standard_normal((N, d_out, k), dtype=np.float32)
    header = sck.spec_header(spec)
    zero = np.zeros((N, k), np.float32)
    cols = {"w": list(W.transpose(1, 0, 2)), "g": list(G.transpose(1, 0, 2)), "shape": (N, k),
            **{f"a{m}": A[:, m] for m in range(d_in)}}
    env = _evaluate(_body(header, "symcon_forward"), dict(cols, b=[zero] * d_out))
    B = np.stack(env["b"], axis=1)
    reached = {g[0] for g in _groups(spec)}
    env = _evaluate(_body(header, "symcon_backward"),
                    dict(cols, da=[zero] * d_in,
                         dW=[zero if r not in reached else None for r in range(p_total)]))
    dA, dW = np.stack(env["da"], axis=1), np.stack(env["dW"], axis=1)
    tA, tW, tG = map(torch.from_numpy, (A, W, G))
    want = [sck.symcon_plain(tA, tW, spec), *sck.symcon_bwd_plain(tA, tW, tG, spec)]
    for got, w in zip((B, dA, dW), want):
        w = w.numpy()
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= 2e-5 * max(1.0, float(np.abs(w).max()))


# the CUDA names the symmetric-contraction sources use, for a host build
HOST_CUDA = """#pragma once
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct HostDim { unsigned x; };
static HostDim blockIdx, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
"""
# round_op.cuh for a host build of the fp32 first-order source: no rounding
HOST_ROUND = """#pragma once
inline float round_op(float x) { return x; }
"""
HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
template <int PART>
void run_parts(const float* A, const float* W, const float* G, const float* U, const float* V,
               float* dA, float* dW, float* dG, int N, int k) {
  if constexpr (PART < SECOND_ORDER_PARTS) {
    for (unsigned b = 0; b * THREADS < (unsigned long)N * k; ++b)
      for (unsigned t = 0; t < THREADS; ++t) {
        blockIdx.x = b;
        threadIdx.x = t;
        symcon_dbl_kernel<PART>(A, W, G, U, V, dA, dW, dG, N, k);
      }
    run_parts<PART + 1>(A, W, G, U, V, dA, dW, dG, N, k);
  }
}
int main(int argc, char** argv) {
  const int N = atoi(argv[1]), k = atoi(argv[2]);
  const long n_in = (long)N * D_IN * k, n_w = (long)N * P_TOTAL * k, n_g = (long)N * D_OUT * k;
  float *A = new float[n_in], *W = new float[n_w], *G = new float[n_g], *U = new float[n_in];
  float *V = new float[n_w], *dA = new float[n_in], *dW = new float[n_w], *dG = new float[n_g];
  FILE* f = fopen(argv[3], "rb");
  if (fread(A, 4, n_in, f) + fread(W, 4, n_w, f) + fread(G, 4, n_g, f) + fread(U, 4, n_in, f)
      + fread(V, 4, n_w, f) != (size_t)(2 * n_in + 2 * n_w + n_g)) return 1;
  fclose(f);
  run_parts<0>(A, W, G, U, V, dA, dW, dG, N, k);
  f = fopen(argv[4], "wb");
  fwrite(dA, 4, n_in, f); fwrite(dW, 4, n_w, f); fwrite(dG, 4, n_g, f);
  fclose(f);
  return 0;
}
"""


def _host_build(tmp_path, source, spec, main):
    """Build ``source`` (a file of csrc/) with ``spec``'s fp32 header and
    ``main`` in place of its C entry points, for the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    text = (Path(sck.__file__).resolve().parents[2] / "csrc" / source).read_text()
    (tmp_path / "cuda_runtime.h").write_text(HOST_CUDA)
    (tmp_path / "round_op.cuh").write_text(HOST_ROUND)
    (tmp_path / "spec.h").write_text(sck.spec_header(spec, "fp32"))
    (tmp_path / "kernel.cpp").write_text(text.split("// ---- host launchers")[0] + main)
    # -O0: g++ -O1 took 100 s over MACE-MP-0 large's first-order switch, -O0 10 s
    subprocess.run(["g++", "-O0", "-std=c++17", "-w", f"-I{tmp_path}", '-DKERNEL_HEADER="spec.h"',
                    "-o", str(tmp_path / "kernel"), str(tmp_path / "kernel.cpp")],
                   check=True, timeout=240)
    return tmp_path / "kernel"


HOST_FIRST_ORDER_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
  const int N = atoi(argv[1]), k = atoi(argv[2]);
  const long n_in = (long)N * D_IN * k, n_w = (long)N * P_TOTAL * k, n_g = (long)N * D_OUT * k;
  float *A = new float[n_in], *W = new float[n_w], *G = new float[n_g], *B = new float[n_g];
  float *dA = new float[n_in], *dW = new float[n_w];
  FILE* f = fopen(argv[3], "rb");
  if (fread(A, 4, n_in, f) + fread(W, 4, n_w, f) + fread(G, 4, n_g, f)
      != (size_t)(n_in + n_w + n_g)) return 1;
  fclose(f);
  for (unsigned b = 0; b * THREADS < (unsigned long)N * k; ++b)
    for (unsigned t = 0; t < THREADS; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      symcon_fwd_kernel(A, W, B, N, k);
      symcon_bwd_kernel(A, W, G, dA, dW, N, k);
    }
  f = fopen(argv[4], "wb");
  fwrite(B, 4, n_g, f); fwrite(dA, 4, n_in, f); fwrite(dW, 4, n_w, f);
  fclose(f);
  return 0;
}
"""


@pytest.mark.parametrize("name", sorted(SPECS))
def test_first_order_source_built_for_the_host_matches_the_plain_versions(name, tmp_path):
    """The forward and backward kernels' indexing, the header's loops and
    their sums, run on the CPU (fp32): every thread of the grid (N * k =
    35) against ``symcon_plain`` and ``symcon_bwd_plain`` at the kernel
    tolerance."""
    spec = SPECS[name]
    exe = _host_build(tmp_path, sck.SYMCON_FWD.source, spec, HOST_FIRST_ORDER_MAIN)
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    N, k = 5, 7
    d_in, P, d_out = spec.in_spec.dim, sck.p_total_of(spec), spec.out_spec.dim
    ops = [rng.standard_normal((N, d, k), dtype=np.float32) for d in (d_in, P, d_out)]
    (tmp_path / "in.bin").write_bytes(b"".join(x.tobytes() for x in ops))
    subprocess.run([str(exe), str(N), str(k), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=60)
    got = np.split(np.fromfile(tmp_path / "out.bin", np.float32),
                   [N * d_out * k, N * (d_out + d_in) * k])
    tA, tW, tG = map(torch.from_numpy, ops)
    want = [sck.symcon_plain(tA, tW, spec), *sck.symcon_bwd_plain(tA, tW, tG, spec)]
    for g, w in zip(got, want):
        w = w.numpy().ravel()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-5 * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_second_order_source_built_for_the_host_matches_the_plain_version(name, tmp_path):
    """The kernel's indexing, the header's switch and its sums, run on the
    CPU: every thread of the grid (N * k = 35, one partial block), each
    launch of ``SECOND_ORDER_PARTS`` in turn, against ``symcon_dbl_plain``
    at the kernel tolerance."""
    spec = SPECS[name]
    exe = _host_build(tmp_path, sck.SYMCON_DBL.source, spec, HOST_MAIN)
    rng = np.random.default_rng(sum(map(ord, name)))
    N, k = 5, 7
    d_in, P, d_out = spec.in_spec.dim, sck.p_total_of(spec), spec.out_spec.dim
    ops = [rng.standard_normal((N, d, k), dtype=np.float32) for d in (d_in, P, d_out, d_in, P)]
    (tmp_path / "in.bin").write_bytes(b"".join(x.tobytes() for x in ops))
    subprocess.run([str(exe), str(N), str(k), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=60)
    out = np.fromfile(tmp_path / "out.bin", np.float32)
    got = np.split(out, [N * d_in * k, N * (d_in + P) * k])
    want = sck.symcon_dbl_plain(*map(torch.from_numpy, ops), spec)
    for g, w in zip(got, want):
        w = w.numpy().ravel()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-5 * max(1.0, float(np.abs(w).max()))


# a CG entry of order nu in symcon_second: its pair products, s and ds, and
# da's product-rule term for each of its nu positions, each summed in (the
# first entry of a group starts s and ds, so two adds fewer)
ENTRY_OPS = {1: 6, 2: 18, 3: 37}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_second_order_ops_count_the_generated_arithmetic(name):
    """``second_order_ops`` (the operations of chip_smoke's bound for the
    second-order kernel) against a count by hand: per
    entry ``ENTRY_OPS``; per group gw and gv, dg's two products summed in,
    and dw's product, summed in unless the group starts a weight row."""
    groups = _groups(SPECS[name])
    want = 0
    for i, (w_idx, _, nu, n, _) in enumerate(groups):
        starts_row = i == 0 or groups[i - 1][0] != w_idx
        want += n * ENTRY_OPS[nu] - 2 + 2 + 4 + (1 if starts_row else 2)
    assert sck.second_order_ops(SPECS[name]) == want


def test_second_order_parts_keep_at_most_four_output_rows_live():
    """The second order's launches: whole output irreps, at most
    ``SECOND_ORDER_PART_ROWS`` rows each unless one irrep alone has more;
    one launch at the paper's spec, two at MACE-MP-0 large's (rows 0-3,
    then l = 2's five)."""
    assert sck.SECOND_ORDER_PART_ROWS == 4
    assert sck.second_order_parts(SPECS["paper"]) == [(0, 4)]
    assert sck.second_order_parts(SPECS["in01_out02_nu1"]) == [(0, 1), (1, 6)]
    assert sck.second_order_parts(SPECS["mp0_large"]) == [(0, 4), (4, 9)]
    header = sck.spec_header(SPECS["mp0_large"])
    assert "constexpr int SECOND_ORDER_PARTS = 2;" in header
    lines = header.splitlines()
    for p, first in ((0, "  for (int m = 0; m < D_IN; ++m) da[m] = 0.f;"),
                     (1, "  for (int m = 0; m < D_IN; ++m) da[m] = dA[m * k];")):
        start = lines.index(f"__device__ __forceinline__ void symcon_second<{p}>(")
        body = lines[start:lines.index("}", start)]
        assert first in body and ("  float g[4], da[D_IN], dg[4];" if p == 0
                                  else "  float g[5], da[D_IN], dg[5];") in body
