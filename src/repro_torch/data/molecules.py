"""Synthetic molecular-graph dataset mirroring the paper's Table 3 mixture.

Eight "chemical systems" with the paper's proportions, per-system vertex
count ranges, and distinct sparsity regimes (crystalline = regular lattice,
amorphous = random packing; density controls edge count at the 4.5 Å cutoff).
Graphs are generated lazily and deterministically per index, so the dataset
scales to millions of samples without materialisation — only ``sizes`` is
precomputed (what Algorithm 1 consumes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# name, proportion, (min_atoms, max_atoms), packing ('lattice' | 'amorphous'),
# density scale (controls neighbor count / sparsity diversity, cf. Fig. 5)
TABLE3_MIXTURE: List[Tuple[str, float, Tuple[int, int], str, float]] = [
    ("MPtrj",          0.60, (1, 444),   "lattice",   1.00),
    ("water_clusters", 0.17, (9, 75),    "amorphous", 0.80),
    ("TMD",            0.08, (16, 96),   "lattice",   1.20),
    ("liquid_water",   0.07, (768, 768), "amorphous", 0.90),
    ("zeolite",        0.04, (203, 408), "lattice",   0.70),
    ("CuNi",           0.03, (492, 500), "lattice",   1.40),
    ("HEA",            0.01, (36, 48),   "lattice",   1.30),
    ("AlHCl_aq",       0.001, (281, 281), "amorphous", 0.85),
]

N_SPECIES = 10
R_CUTOFF = 4.5
TARGET_SPACING = 2.4  # Å typical interatomic distance


@dataclasses.dataclass
class Molecule:
    species: np.ndarray    # [n] int32
    positions: np.ndarray  # [n, 3] float32
    senders: np.ndarray    # [e] int32 (directed edges, both directions)
    receivers: np.ndarray  # [e] int32
    energy: float
    forces: np.ndarray     # [n, 3] float32
    system: str

    @property
    def n_atoms(self) -> int:
        return len(self.species)

    @property
    def n_edges(self) -> int:
        return len(self.senders)


class SyntheticCFMDataset:
    """Deterministic lazy dataset; ``sizes`` is cheap, ``get(i)`` builds the
    graph (positions + cutoff edges + synthetic labels)."""

    def __init__(
        self,
        n_graphs: int,
        seed: int = 0,
        r_cutoff: float = R_CUTOFF,
        max_atoms: int | None = None,
    ):
        self.n_graphs = n_graphs
        self.seed = seed
        self.r_cutoff = r_cutoff
        rng = np.random.default_rng(seed)
        props = np.array([m[1] for m in TABLE3_MIXTURE])
        props = props / props.sum()
        self._system = rng.choice(len(TABLE3_MIXTURE), size=n_graphs, p=props)
        lo = np.array([m[2][0] for m in TABLE3_MIXTURE])
        hi = np.array([m[2][1] for m in TABLE3_MIXTURE])
        u = rng.random(n_graphs)
        self.sizes = (lo[self._system] + u * (hi[self._system] - lo[self._system] + 1)).astype(np.int64)
        self.sizes = np.minimum(self.sizes, hi[self._system]).astype(np.int64)
        if max_atoms is not None:
            # scaled-down variant for CPU tests/examples: cap graph sizes
            self.sizes = np.minimum(self.sizes, max_atoms)

    def __len__(self) -> int:
        return self.n_graphs

    def system_name(self, i: int) -> str:
        return TABLE3_MIXTURE[self._system[i]][0]

    def get(self, i: int) -> Molecule:
        name, _, _, packing, density = TABLE3_MIXTURE[self._system[i]]
        n = int(self.sizes[i])
        rng = np.random.default_rng((self.seed, 1315423911, i))

        spacing = TARGET_SPACING / density ** (1.0 / 3.0)
        if packing == "lattice":
            side = int(np.ceil(n ** (1.0 / 3.0)))
            grid = np.stack(
                np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
            ).reshape(-1, 3)[:n]
            pos = grid * spacing + rng.normal(0, 0.08 * spacing, (n, 3))
        else:
            # amorphous: uniform in a box at the target number density
            box = spacing * max(n, 2) ** (1.0 / 3.0) * 1.12
            pos = rng.random((n, 3)) * box

        species = rng.integers(0, N_SPECIES, n).astype(np.int32)
        senders, receivers = _cutoff_edges(pos, self.r_cutoff)

        # synthetic labels: smooth pair potential (so training has signal)
        energy, forces = _pair_potential(pos, senders, receivers, self.r_cutoff)
        return Molecule(
            species=species,
            positions=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            energy=float(energy),
            forces=forces.astype(np.float32),
            system=name,
        )


def _cutoff_edges(pos: np.ndarray, r_cut: float):
    """Directed edge list (both directions) for pairs within r_cut.
    Cell-list construction: O(n) for bounded density."""
    n = len(pos)
    if n <= 1:
        z = np.zeros((0,), np.int32)
        return z, z.copy()
    cell = float(r_cut)
    keys = np.floor(pos / cell).astype(np.int64)
    cells: Dict[Tuple[int, int, int], List[int]] = {}
    for i, k in enumerate(map(tuple, keys)):
        cells.setdefault(k, []).append(i)
    send, recv = [], []
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
    for (cx, cy, cz), members in cells.items():
        neigh = []
        for (dx, dy, dz) in offs:
            neigh.extend(cells.get((cx + dx, cy + dy, cz + dz), ()))
        if not neigh:
            continue
        na = np.asarray(neigh)
        for i in members:
            d = np.linalg.norm(pos[na] - pos[i], axis=1)
            js = na[(d < r_cut) & (na != i)]
            send.extend([i] * len(js))
            recv.extend(js.tolist())
    return np.asarray(send, np.int32), np.asarray(recv, np.int32)


def _pair_potential(pos, senders, receivers, r_cut):
    """Smooth short-range pair potential + its exact forces (labels)."""
    if len(senders) == 0:
        return 0.0, np.zeros_like(pos)
    vec = pos[receivers] - pos[senders]
    r = np.linalg.norm(vec, axis=1)
    x = np.clip(r / r_cut, 1e-6, 1.0)
    # phi(r) = (1-x)^2, dphi/dr = -2 (1-x) / r_cut
    e = 0.5 * np.sum((1 - x) ** 2)  # 0.5: each pair counted twice
    dedr = -2.0 * (1 - x) / r_cut
    f_edge = (0.5 * dedr / np.maximum(r, 1e-9))[:, None] * vec
    forces = np.zeros_like(pos)
    np.add.at(forces, senders, f_edge)
    np.add.at(forces, receivers, -f_edge)
    return e, forces
