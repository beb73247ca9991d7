"""Each CUDA kernel's bytes and operations at a bin's real counts, and the
least time the card could take for them.

The formulas are frozen copies of ``chip_smoke.py``'s (``_symcon_work``
and the bytes and operations ``_kernel_calls`` gives the interaction
kernels), read with the real atoms and edges in place of the padded rows
and edge slots: each input byte read once, each output byte written once,
the operations these inputs need.  ``bound_s`` is the larger of operations
over the fp32 peak and bytes over the HBM bandwidth (``PEAKS``: NVIDIA's
data sheet for the H100 SXM at its 700 W limit).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.reference import cg
from perfbench.reference.mace import Config, _dim

PEAKS = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
# the kernel symbols as the profiler names them, by kernel
SYMBOLS = {"symcon_fwd": "symcon_fwd_kernel", "symcon_bwd": "symcon_bwd_kernel",
           "tp_scatter_fwd": "tp_scatter_kernel", "tp_gather_bwd": "tp_gather_bwd_kernel"}


def symcon_groups(cfg: Config) -> Tuple[List[Tuple[int, int]], int]:
    """([(nu, entries)] per (term, eta, M) group, total weight paths)."""
    groups, p_total = [], 0
    for L, nu, n_paths in cfg.symcon_terms():
        U = cg.u_tensor(tuple(cfg.a_ls), L, nu)
        nz = (U != 0).reshape(-1, 2 * L + 1, n_paths).sum(axis=0)  # [M, eta]
        groups += [(nu, int(c)) for c in nz.T.reshape(-1) if c > 0]
        p_total += n_paths
    return groups, p_total


def work(kernel: str, cfg: Config, layer: int, n_atoms: float,
         n_edges: float) -> Tuple[float, float]:
    """(bytes, operations) of one launch of ``kernel`` at ``layer``."""
    k, N, E = cfg.channels, float(n_atoms), float(n_edges)
    if kernel.startswith("symcon"):
        groups, P = symcon_groups(cfg)
        d_in, d_out = _dim(cfg.a_ls), _dim(cfg.hidden_ls)
        if kernel == "symcon_fwd":
            return (4 * N * k * (d_in + P + d_out),
                    sum(n * (nu + 1) + 2 for nu, n in groups) * N * k)
        return (4 * N * k * (2 * (d_in + P) + d_out),
                sum(n * (nu + 1 + nu * (nu + 2)) + 3 for nu, n in groups) * N * k)
    d_sh, d_h = _dim(range(cfg.sh_lmax + 1)), _dim(cfg.h_ls(layer))
    n_paths, d_a = len(cfg.paths(layer)), _dim(cfg.a_ls)
    n_ent = sum(len(cg.cg_nonzeros(*p)) for p in cfg.paths(layer))
    edge_in = 4 * E * (d_sh + (d_h + n_paths) * k) + 5 * E
    if kernel == "tp_scatter_fwd":
        return edge_in + 4 * N * d_a * k, 4 * E * k * n_ent
    if kernel == "tp_gather_bwd":
        return (edge_in + 4 * N * d_a * k + 4 * E * (d_sh + (d_h + n_paths) * k),
                11 * E * k * n_ent)
    raise KeyError(kernel)


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_ops / PEAKS["fp32_flops"])


def launch_bound_s(kernel: str, cfg: Config, n_atoms: float, n_edges: float) -> float:
    """The bound of one launch on a bin of these real counts, averaged over
    the layers (each layer launches each kernel equally often)."""
    return sum(bound_s(*work(kernel, cfg, t, n_atoms, n_edges))
               for t in range(cfg.n_interactions)) / cfg.n_interactions


def roofline_share(cfg: Config, kernels: Dict[str, Tuple[float, int]], n_atoms: float,
                   n_edges: float):
    """Sum of bounds over sum of device seconds of the four kernels'
    launches; ``kernels``: {kernel: (device seconds, launches)} and the mean
    bin's real counts.  None when no launch was seen."""
    dev = sum(s for s, _ in kernels.values())
    if dev <= 0:
        return None
    bound = sum(n * launch_bound_s(name, cfg, n_atoms, n_edges)
                for name, (_, n) in kernels.items())
    return bound / dev
