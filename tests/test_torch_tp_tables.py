"""The header the interaction kernels are built from (``spec_header``): each
of its four sums (the forward's messages by m3; the backward's dh by m2, dR
by path and dY by m1) unrolls, for every group, exactly the spec's CG
entries with that index, in table order and with their float32 values, and
sets a group without entries to zero.  So every entry is used once per sum
and every output element is written.

Runs on the CPU; the specs are both interaction layers of the paper's
configuration and the small specs of the other interaction tests.
"""
import re

import numpy as np
import pytest

from repro_torch.configs.mace_cfm import CONFIG
from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.kernels.channelwise_tp import kernel as tpk

SPECS = {
    "paper_layer0": CONFIG.tp_spec_at(0),
    "paper_layer1": CONFIG.tp_spec_at(1),
    "lmax2_h0_out012": TPSpec(sh_spec(2), lspec(0), lspec(0, 1, 2)),
    "lmax2_h01_out012": TPSpec(sh_spec(2), lspec(0, 1), lspec(0, 1, 2)),
    "lmax3_h0_out0123": TPSpec(sh_spec(3), lspec(0), lspec(0, 1, 2, 3)),
    "lmax3_h01_out0123": TPSpec(sh_spec(3), lspec(0, 1), lspec(0, 1, 2, 3)),
    # out irreps without l = 1: no path reaches the l = 2 rows, empty groups
    "lmax1_h0_out02": TPSpec(sh_spec(1), lspec(0), lspec(0, 2)),
}
FIELD = {"m1": 0, "m2": 1, "m3": 2, "path": 3}
# the header's sums: grouping key, the term's pattern and its indices
SUMS = {
    "msg": ("m3", r"\(y\[(\d+)\] \* (\S+)\) \* h\[(\d+)\] \* r\[(\d+)\]", ("m1", "val", "m2", "path")),
    "dh": ("m2", r"\(g\[(\d+)\] \* r\[(\d+)\]\) \* \(y\[(\d+)\] \* (\S+)\)", ("m3", "path", "m1", "val")),
    "dr": ("path", r"\(g\[(\d+)\] \* h\[(\d+)\]\) \* \(y\[(\d+)\] \* (\S+)\)", ("m3", "m2", "m1", "val")),
    "dy": ("m1", r"g\[(\d+)\] \* h\[(\d+)\] \* r\[(\d+)\] \* (\S+)", ("m3", "m2", "path", "val")),
}


def _n_groups(spec, key):
    d_sh, d_h, n_paths, d_out = tpk.spec_dims(spec)
    return {"m1": d_sh, "m2": d_h, "m3": d_out, "path": n_paths}[key]


def _statements(header, target):
    """``(g, "=" or "+=", term indices or None for a zero)`` of a sum."""
    names = SUMS[target][2]
    stmt = re.compile(rf"^  {target}\[(\d+)\] (\+?=) (?:{SUMS[target][1]}|0\.f);$")
    out = []
    for m in filter(None, map(stmt.match, header.splitlines())):
        fields = m.groups()[2:]
        terms = None if fields[0] is None else tuple(
            float.fromhex(v[:-1]) if n == "val" else int(v) for n, v in zip(names, fields))
        out.append((int(m.group(1)), m.group(2), terms))
    return out


@pytest.mark.parametrize("target", sorted(SUMS))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_header_unrolls_the_entries_by_group(name, target):
    """The sum, read back statement by statement, is group 0, 1, ... of the
    CG entries (those with the key's index g, in table order); an empty
    group is a single ``= 0.f``."""
    spec = SPECS[name]
    key, _, names = SUMS[target]
    entries = tpk.tp_entries(spec)
    want = []
    for g in range(_n_groups(spec, key)):
        group = [e for e in entries if e[FIELD[key]] == g]
        if not group:
            want.append((g, "=", None))
        for j, (m1, m2, m3, p, val) in enumerate(group):
            idx = dict(m1=m1, m2=m2, m3=m3, path=p, val=float(np.float32(val)))
            want.append((g, "=" if j == 0 else "+=", tuple(idx[n] for n in names)))
    assert _statements(tpk.spec_header(spec), target) == want


@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_header_covers_every_group_and_entry(name):
    """The header states the spec's dimensions; each sum starts every group
    once (so every output element is written), and its terms are the CG
    entries, each once."""
    spec = SPECS[name]
    header = tpk.spec_header(spec)
    d_sh, d_h, n_paths, d_out = tpk.spec_dims(spec)
    assert (f"constexpr int D_SH = {d_sh}, D_H = {d_h}, N_P = {n_paths}, "
            f"D_OUT = {d_out};") in header
    n_ent = len(tpk.tp_entries(spec))
    for target, (key, _, _) in SUMS.items():
        got = _statements(header, target)
        starts = [g for g, op, _ in got if op == "="]
        assert starts == list(range(_n_groups(spec, key))), target
        assert sum(t is not None for _, _, t in got) == n_ent, target
    if name == "lmax1_h0_out02":  # a message row no entry reaches
        assert any(t is None for _, _, t in _statements(header, "msg"))
