"""Model FLOPs of MACE from a bin's real atoms and edges.

A frozen copy of the arithmetic of the port's
``roofline/analytic.py::mace_cell_cost`` (its ``fused=True`` branch: the
useful FLOPs of the sparse CG tables), fed real counts instead of the padded
capacity.  A training step is 7 forwards (the forward, the forces' graph
and the loss's backward through both, ``mace_cell_cost``'s convention);
serving's forward and forces are 3.  A CPU test holds ``forward_flops`` at
the padded counts equal to ``mace_cell_cost``.
"""
from __future__ import annotations

from perfbench.reference import cg
from perfbench.reference.mace import Config, _dim

TRAIN_FACTOR = 7.0
SERVE_FACTOR = 3.0


def tp_nnz(cfg: Config, layer: int) -> int:
    return sum(len(cg.cg_nonzeros(*p)) for p in cfg.paths(layer))


def symcon_flops(cfg: Config, n_atoms: float) -> float:
    total = 0.0
    for L, nu, _ in cfg.symcon_terms():
        nnz = int((cg.u_tensor(tuple(cfg.a_ls), L, nu) != 0).sum())
        total += n_atoms * cfg.channels * nnz * (nu + 1)
        total += n_atoms * cfg.channels * nnz * (2 * L + 1) * 2
    return total


def forward_flops(cfg: Config, n_atoms: float, n_edges: float) -> float:
    """FLOPs of one forward over ``n_atoms`` atoms and ``n_edges`` edges."""
    k, N, E = cfg.channels, float(n_atoms), float(n_edges)
    d_a, d_hid = _dim(cfg.a_ls), _dim(cfg.hidden_ls)
    fwd = 0.0
    for t in range(cfg.n_interactions):
        fwd += E * k * tp_nnz(cfg, t) * 4.0 + E * k * d_a * 2.0
        dims = (cfg.num_bessel, *cfg.radial_mlp, len(cfg.paths(t)) * k)
        fwd += sum(2.0 * E * a * b for a, b in zip(dims[:-1], dims[1:]))
        fwd += 2.0 * N * k * k * (_dim(cfg.h_ls(t)) + d_a + d_hid)
        fwd += symcon_flops(cfg, N)
        fwd += 2.0 * N * k * k
    return fwd + 2.0 * N * k
