"""The benchmark's own graphs: a frozen copy of the port's
``data/molecules.py`` (the paper's Table-3 mixture), uncapped, at a
configuration's cutoff, with the edges found by vectorised all-pairs
distances instead of the cell list.

The sizes, species, positions and labels are drawn exactly as the port
draws them (the same generators, the same formulas); a CPU test holds the
edges equal, as sets, to the cell-list original and the rest equal to it.
Every graph of a run is built before the measured window, as a loader
reads preprocessed graphs: the window never runs this code.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

# name, proportion, (min_atoms, max_atoms), packing, density scale
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
TARGET_SPACING = 2.4  # Å typical interatomic distance


@dataclasses.dataclass
class Molecule:
    """One graph, with the fields the port's collation and server read."""

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


def draw_sizes(n_graphs: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(system index, atom count) of each graph, as the port draws them."""
    rng = np.random.default_rng(seed)
    props = np.array([m[1] for m in TABLE3_MIXTURE])
    props = props / props.sum()
    system = rng.choice(len(TABLE3_MIXTURE), size=n_graphs, p=props)
    lo = np.array([m[2][0] for m in TABLE3_MIXTURE])
    hi = np.array([m[2][1] for m in TABLE3_MIXTURE])
    u = rng.random(n_graphs)
    sizes = (lo[system] + u * (hi[system] - lo[system] + 1)).astype(np.int64)
    return system, np.minimum(sizes, hi[system]).astype(np.int64)


def cutoff_edges(pos: np.ndarray, r_cut: float) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edges (both directions) of every pair closer than
    ``r_cut``, by all-pairs squared distances: sender-major, receivers
    ascending.  (The original compares the distance itself; the two differ
    only for a pair within a rounding step of the cutoff.)"""
    n = len(pos)
    if n <= 1:
        z = np.zeros((0,), np.int32)
        return z, z.copy()
    diff = pos[None, :, :] - pos[:, None, :]
    keep = np.einsum("ijc,ijc->ij", diff, diff) < r_cut * r_cut
    np.fill_diagonal(keep, False)
    send, recv = np.nonzero(keep)
    return send.astype(np.int32), recv.astype(np.int32)


def pair_potential(pos, senders, receivers, r_cut):
    """Smooth short-range pair potential and its exact forces (labels)."""
    if len(senders) == 0:
        return 0.0, np.zeros_like(pos)
    vec = pos[receivers] - pos[senders]
    r = np.linalg.norm(vec, axis=1)
    x = np.clip(r / r_cut, 1e-6, 1.0)
    e = 0.5 * np.sum((1 - x) ** 2)
    dedr = -2.0 * (1 - x) / r_cut
    f_edge = (0.5 * dedr / np.maximum(r, 1e-9))[:, None] * vec
    n = len(pos)
    forces = np.stack([np.bincount(senders, f_edge[:, c], minlength=n)
                       - np.bincount(receivers, f_edge[:, c], minlength=n)
                       for c in range(3)], axis=1)
    return e, forces


def make_molecule(seed: int, i: int, system: int, n: int, r_cut: float) -> Molecule:
    name, _, _, packing, density = TABLE3_MIXTURE[system]
    rng = np.random.default_rng((seed, 1315423911, i))
    spacing = TARGET_SPACING / density ** (1.0 / 3.0)
    if packing == "lattice":
        side = int(np.ceil(n ** (1.0 / 3.0)))
        grid = np.stack(
            np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
        ).reshape(-1, 3)[:n]
        pos = grid * spacing + rng.normal(0, 0.08 * spacing, (n, 3))
    else:
        box = spacing * max(n, 2) ** (1.0 / 3.0) * 1.12
        pos = rng.random((n, 3)) * box
    species = rng.integers(0, N_SPECIES, n).astype(np.int32)
    senders, receivers = cutoff_edges(pos, r_cut)
    energy, forces = pair_potential(pos, senders, receivers, r_cut)
    return Molecule(species, pos.astype(np.float32), senders, receivers,
                    float(energy), forces.astype(np.float32), name)


class GraphSet:
    """``n_graphs`` graphs of the mixture drawn from ``seed`` at the cutoff
    ``r_cut``, all built at construction.  ``size_seed``, if given, draws
    each graph's system and size instead, so that runs of different seeds
    hold the same structures' sizes (a fixed training set, or a fixed pool)
    and differ in their coordinates, species and labels; ``max_atoms`` caps
    the sizes.  It offers what the port's
    trainer reads of a dataset: ``sizes``, ``len`` and ``get(i)``."""

    def __init__(self, n_graphs: int, seed: int, r_cut: float,
                 max_atoms: Optional[int] = None, size_seed: Optional[int] = None,
                 threads: int = 8):
        self.seed = seed
        self.r_cut = r_cut
        self.system, self.sizes = draw_sizes(n_graphs, seed if size_seed is None else size_seed)
        if max_atoms is not None:  # the port's cap, for CPU-sized runs
            self.sizes = np.minimum(self.sizes, max_atoms)
        # numpy releases the interpreter lock in the all-pairs arithmetic;
        # each graph has its own generator, so the threads change nothing
        with ThreadPoolExecutor(threads) as pool:
            self.graphs = list(pool.map(
                lambda a: make_molecule(seed, a[0], int(a[1]), int(a[2]), r_cut),
                zip(range(n_graphs), self.system, self.sizes)))
        self.edges = np.asarray([m.n_edges for m in self.graphs], np.int64)

    def __len__(self) -> int:
        return len(self.graphs)

    def get(self, i: int) -> Molecule:
        return self.graphs[i]
