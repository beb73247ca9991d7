"""The numbers that decide ``correct``: what the timed path produced against
what the reference works out again from the same inputs.

Training (the first steps of the run's own ``Trainer.train``):

* ``loss_gap``: the largest, over the steps, of |loss - ref| / |ref|;
* ``grad_gap``: the first step's clipped gradient as AdamW got it (read
  back from its first moment, ``m / (1 - b1)``), by the worst leaf: the gap
  between the leaf's norm and the reference's, over the larger of the
  reference leaf's norm and the median leaf's;
* ``change_gap`` and ``ema_gap``: the same measure of the parameters' and
  of the EMA's change over the steps, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (AdamW
  moves those by rounding alone);
* ``bad_bins``: bins of the window that are no valid Algorithm-1 packing
  of the run's graphs (over capacity, edge slots or graph slots, or a graph
  twice in one epoch).

Serving (a sample, drawn from the seed, of the requests completed in the
window, with the largest among them):

* ``energy_gap``: the largest |E - ref| per atom over the median of the
  sample's |ref| per atom;
* ``forces_gap``: the largest |F - ref| of any component over the RMS of
  the sample's reference forces;
* ``lost``: requests of the window that failed or never came back.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

GRAD_FLOOR = 1e-3   # leaves under this share of the median leaf's gradient


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keys: Iterable[str]) -> float:
    """Worst leaf: |norm(got) - norm(want)| / max(norm(want), median norm)."""
    keys = list(keys)
    g, w = _norms({k: got[k] for k in keys}), _norms({k: want[k] for k in keys})
    med = float(np.median([w[k] for k in keys]))
    return max(abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys)


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    n = _norms(ref_grad)
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= GRAD_FLOOR * med]


def train_numbers(prog: Dict, ref: Dict, flat0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses", "grad", "params", "ema"} (flat
    dicts of tensors); ``flat0`` the initial parameters."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    keys = list(flat0)
    moved = moved_leaves(ref["grad"])
    delta = lambda tree: {k: tree[k] - flat0[k] for k in moved}  # noqa: E731
    return {
        "loss_gap": max(losses),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], keys),
        "change_gap": leaf_gap(delta(prog["params"]), delta(ref["params"]), moved),
        "ema_gap": leaf_gap(delta(prog["ema"]), delta(ref["ema"]), moved),
    }


def bad_bins(bins: Sequence[Sequence[int]], epochs: Sequence[int], sizes: np.ndarray,
             edges: np.ndarray, capacity: int, edge_slots: int, max_graphs: int) -> int:
    """Bins that break the packing's guarantees (see the module docstring)."""
    bad, seen = 0, {}
    for b, ep in zip(bins, epochs):
        idx = np.asarray(b, np.int64)
        mine = seen.setdefault(ep, set())
        ok = (idx.size > 0 and idx.min() >= 0 and idx.max() < len(sizes)
              and len(set(b)) == len(b) and not mine.intersection(b))
        if ok:
            ok = (int(sizes[idx].sum()) <= capacity and int(edges[idx].sum()) <= edge_slots
                  and len(b) <= max_graphs)
        mine.update(b)
        bad += not ok
    return bad


def serve_numbers(got_e, got_f, ref_e, ref_f, n_atoms) -> Dict[str, float]:
    """Per-molecule energies and concatenated forces, program and reference."""
    got_e, ref_e = np.asarray(got_e, np.float64), np.asarray(ref_e, np.float64)
    per_atom = np.abs(got_e - ref_e) / np.asarray(n_atoms, np.float64)
    scale = float(np.median(np.abs(ref_e) / np.asarray(n_atoms, np.float64)))
    got_f, ref_f = np.asarray(got_f, np.float64), np.asarray(ref_f, np.float64)
    rms = float(np.sqrt(np.mean(ref_f ** 2))) if ref_f.size else 1.0
    return {"energy_gap": float(per_atom.max()) / max(scale, 1e-30),
            "forces_gap": float(np.abs(got_f - ref_f).max(initial=0.0)) / max(rms, 1e-30)}
