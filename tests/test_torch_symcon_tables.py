"""The header the symmetric-contraction kernels are built from
(``spec_header``), read back statement by statement: each sum unrolls
exactly the CG groups' entries in table order with their float32 values,
every row of b, dw and da is started once (a row no group reaches is
``= 0.f``), and every entry is used once per sum.  The parsed statements,
evaluated with numpy in float32 on random A, W, G, agree with the plain
versions ``symcon_plain`` and ``symcon_bwd_plain``.

Runs on the CPU.  Specs: the paper's; nu_max 1 (no entry reaches the
l = 2, 3 rows of A in the backward); nu_max 3 on A irreps 0+1+2 (33 groups,
523 entries); A irreps 0+1 -> B irreps 0+2 at nu_max 1, whose output rows
1-5 no group reaches.
"""
import re

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
