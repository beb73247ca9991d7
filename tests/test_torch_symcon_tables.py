"""The header the symmetric-contraction kernels are built from
(``spec_header``), read back statement by statement: each sum unrolls
exactly the CG groups' entries in table order with their float32 values,
every row of b, dw and da is started once (a row no group reaches is
``= 0.f``), and every entry is used once per sum.  The parsed statements,
evaluated with numpy in float32 on random A, W, G, agree with the plain
versions ``symcon_plain`` and ``symcon_bwd_plain``.

The second-order kernel's source, with the same header, is built for the
host by g++ (the CUDA names stubbed, the grid run as a loop) and held to
``symcon_dbl_plain``.

Runs on the CPU.  Specs: the paper's; nu_max 1 (no entry reaches the
l = 2, 3 rows of A in the backward); nu_max 3 on A irreps 0+1+2 (33 groups,
523 entries); A irreps 0+1 -> B irreps 0+2 at nu_max 1, whose output rows
1-5 no group reaches.
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
}
HEX = r"-?0x[0-9a-f.]+p[+-]\d+f"
STMT = re.compile(r"^  (?:const float )?(\w+)(?:\[(\d+)\])? (\+?=) (.+);$")


def _groups(spec):
    return sck._group_entries(spec, build_symcon_tables(spec))[0]


def _f32(v):
    return float(np.float32(v))


def _body(header, fn):
    """The statements ``(target, row or None, op, expression)`` of one of the
    header's two functions, in order."""
    lines = header.splitlines()
    start = next(i for i, l in enumerate(lines) if f" {fn}(" in l)
    start = next(i for i in range(start, len(lines)) if lines[i].endswith("{")) + 1
    out = []
    for line in lines[start:lines.index("}", start)]:
        if line == "  float s;":
            continue
        m = STMT.match(line)
        assert m, line
        target, row, op, expr = m.groups()
        out.append((target, None if row is None else int(row), op, expr))
    return out


def _product(expr):
    """``a[i] * a[j] * VAL`` -> ((i, j), VAL)."""
    m = re.fullmatch(rf"((?:a\[\d+\] \* )*)({HEX})", expr)
    assert m, expr
    return tuple(int(i) for i in re.findall(r"a\[(\d+)\]", m.group(1))), \
        float.fromhex(m.group(2)[:-1])


def _split_sums(stmts, close):
    """Per group: its ``s`` entries and the statement that closes it (the
    ``b`` or ``dw`` row it feeds); then the remaining statements."""
    groups, ents, i = [], [], 0
    while i < len(stmts):
        target, row, op, expr = stmts[i]
        if target == "s":
            assert op == ("=" if not ents else "+=")
            ents.append(_product(expr))
        elif target == close and ents:
            groups.append((ents, stmts[i]))
            ents = []
        else:
            break
        i += 1
        while close == "dw" and i < len(stmts) and stmts[i][0].startswith("gw"):
            groups[-1] = groups[-1] + (stmts[i],)
            i += 1
    assert not ents
    return groups, stmts[i:]


def _want_entries(ents):
    return [(tuple(ix), _f32(v)) for ix, v in ents]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_unrolls_the_groups_in_table_order(name):
    """symcon_contract: per group, in table order, ``s`` over exactly its
    entries, then ``b[out] = / += w[eta] * s``; each b row starts once and
    a row no group reaches is ``= 0.f``."""
    spec = SPECS[name]
    groups = _groups(spec)
    got, rest = _split_sums(_body(sck.spec_header(spec), "symcon_contract"), "b")
    assert len(got) == len(groups)
    seen = set()
    for (ents, (target, row, op, expr)), (w_idx, out_idx, nu, n, want) in zip(got, groups):
        assert ents == _want_entries(want)
        assert all(len(ix) == nu for ix, _ in ents)
        assert (row, op, expr) == (out_idx, "+=" if out_idx in seen else "=",
                                   f"w[{w_idx}] * s")
        seen.add(out_idx)
    unreached = [r for r in range(spec.out_spec.dim) if r not in seen]
    assert rest == [("b", r, "=", "0.f") for r in unreached]
    if name == "in01_out02_nu1":
        assert unreached == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_backward_unrolls_the_groups_and_the_product_rule(name):
    """symcon_transpose: per group the forward's ``s``, ``dw[eta] = / +=
    g[out] * s`` and ``gwJ = g[out] * w[eta]``; then every row m of A in
    order, started once: ``da[m] =`` then ``+=`` its product-rule terms, or
    ``= 0.f`` where no entry holds m (the terms' values are checked by
    ``test_parsed_header_matches_the_plain_versions``)."""
    spec = SPECS[name]
    groups = _groups(spec)
    p_total = sck.p_total_of(spec)
    got, rest = _split_sums(_body(sck.spec_header(spec), "symcon_transpose"), "dw")
    assert len(got) == len(groups)
    seen = set()
    for j, ((ents, dw, gw), (w_idx, out_idx, nu, n, want)) in enumerate(zip(got, groups)):
        assert ents == _want_entries(want)
        assert dw == ("dw", w_idx, "+=" if w_idx in seen else "=", f"g[{out_idx}] * s")
        seen.add(w_idx)
        assert gw == (f"gw{j}", None, "=", f"g[{out_idx}] * w[{w_idx}]")
    zeros = [("dw", r, "=", "0.f") for r in range(p_total) if r not in seen]
    assert rest[:len(zeros)] == zeros
    da = rest[len(zeros):]
    assert all(target == "da" for target, *_ in da)
    assert [row for _, row, op, _ in da if op == "="] == list(range(spec.in_spec.dim))
    started = set()
    for _, row, op, _ in da:
        assert (op == "+=") == (row in started)
        started.add(row)
    held = {m for (_, _, _, _, want) in groups for ix, _ in want for m in ix}
    unheld = [m for m in range(spec.in_spec.dim) if m not in held]
    assert [(row, expr) for _, row, _, expr in da if expr == "0.f"] == \
        [(m, "0.f") for m in unheld]
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
    for fn in ("symcon_contract", "symcon_transpose"):
        assert sum(t == "s" for t, *_ in _body(header, fn)) == n_ent, fn
    da = [e for t, _, _, e in _body(header, "symcon_transpose") if t == "da" and e != "0.f"]
    assert len(da) == n_terms
    if name == "nu3_in012":
        assert (len(groups), n_ent) == (33, 523)


def _evaluate(stmts, env):
    """Run parsed statements on float32 numpy arrays (each operand a list of
    [N, k] rows); return the environment."""
    def f32(m):
        return f"np.float32({float.fromhex(m.group(0)[:-1])!r})"

    for target, row, op, expr in stmts:
        value = np.float32(0) if expr == "0.f" else eval(  # noqa: S307 (generated text)
            re.sub(HEX, f32, expr), {"np": np}, env)
        value = np.broadcast_to(np.asarray(value, np.float32), env["shape"])
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
    cols = {"a": list(A.transpose(1, 0, 2)), "w": list(W.transpose(1, 0, 2)),
            "g": list(G.transpose(1, 0, 2)), "shape": (N, k)}
    env = _evaluate(_body(header, "symcon_contract"), dict(cols, b=[None] * d_out))
    B = np.stack(env["b"], axis=1)
    env = _evaluate(_body(header, "symcon_transpose"),
                    dict(cols, da=[None] * d_in, dw=[None] * p_total))
    dA, dW = np.stack(env["da"], axis=1), np.stack(env["dw"], axis=1)
    tA, tW, tG = map(torch.from_numpy, (A, W, G))
    want = [sck.symcon_plain(tA, tW, spec), *sck.symcon_bwd_plain(tA, tW, tG, spec)]
    for got, w in zip((B, dA, dW), want):
        w = w.numpy()
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= 2e-5 * max(1.0, float(np.abs(w).max()))


# the CUDA names csrc/symmetric_contraction_second.cu uses, for a host build
HOST_CUDA = """#pragma once
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct HostDim { unsigned x; };
static HostDim blockIdx, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
"""
HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
  const int N = atoi(argv[1]), k = atoi(argv[2]);
  const long n_in = (long)N * D_IN * k, n_w = (long)N * P_TOTAL * k, n_g = (long)N * D_OUT * k;
  float *A = new float[n_in], *W = new float[n_w], *G = new float[n_g], *U = new float[n_in];
  float *V = new float[n_w], *dA = new float[n_in], *dW = new float[n_w], *dG = new float[n_g];
  FILE* f = fopen(argv[3], "rb");
  if (fread(A, 4, n_in, f) + fread(W, 4, n_w, f) + fread(G, 4, n_g, f) + fread(U, 4, n_in, f)
      + fread(V, 4, n_w, f) != (size_t)(2 * n_in + 2 * n_w + n_g)) return 1;
  fclose(f);
  for (unsigned b = 0; b * THREADS < (unsigned long)N * k; ++b)
    for (unsigned t = 0; t < THREADS; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      symcon_dbl_kernel(A, W, G, U, V, dA, dW, dG, N, k);
    }
  f = fopen(argv[4], "wb");
  fwrite(dA, 4, n_in, f); fwrite(dW, 4, n_w, f); fwrite(dG, 4, n_g, f);
  fclose(f);
  return 0;
}
"""


@pytest.mark.parametrize("name", sorted(SPECS))
def test_second_order_source_built_for_the_host_matches_the_plain_version(name, tmp_path):
    """The kernel's indexing, the header's switch and its sums, run on the
    CPU: every thread of the grid (N * k = 35, one partial block) against
    ``symcon_dbl_plain`` at the kernel tolerance."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    spec = SPECS[name]
    source = (Path(sck.__file__).resolve().parents[2] / "csrc" / sck.SYMCON_DBL.source).read_text()
    (tmp_path / "cuda_runtime.h").write_text(HOST_CUDA)
    (tmp_path / "spec.h").write_text(sck.spec_header(spec, "fp32"))
    (tmp_path / "kernel.cpp").write_text(source.split('extern "C"')[0] + HOST_MAIN)
    subprocess.run(["g++", "-O1", "-std=c++17", "-w", f"-I{tmp_path}", '-DKERNEL_HEADER="spec.h"',
                    "-o", str(tmp_path / "kernel"), str(tmp_path / "kernel.cpp")],
                   check=True, timeout=240)
    rng = np.random.default_rng(sum(map(ord, name)))
    N, k = 5, 7
    d_in, P, d_out = spec.in_spec.dim, sck.p_total_of(spec), spec.out_spec.dim
    ops = [rng.standard_normal((N, d, k), dtype=np.float32) for d in (d_in, P, d_out, d_in, P)]
    (tmp_path / "in.bin").write_bytes(b"".join(x.tobytes() for x in ops))
    subprocess.run([str(tmp_path / "kernel"), str(N), str(k), str(tmp_path / "in.bin"),
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
