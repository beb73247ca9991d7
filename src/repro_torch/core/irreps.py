"""Lightweight irreps bookkeeping for SO(3)-equivariant features.

All features in this codebase follow the *SH-like parity* convention used by
MACE-MP-0: an irrep of order ``l`` carries parity ``(-1)**l`` (0e, 1o, 2e, 3o,
...).  Under that convention a Clebsch-Gordan path ``l1 x l2 -> l3`` is
parity-allowed iff ``l1 + l2 + l3`` is even, which is exactly the selection
rule enforced by :mod:`repro_torch.core.cg`.

A feature tensor is stored as ``[..., channels, irreps_dim]`` where
``irreps_dim = sum(2l+1 for l in ls)`` and the l-blocks are concatenated in
ascending order of appearance in ``ls``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple


def dim_l(l: int) -> int:
    return 2 * l + 1


@dataclasses.dataclass(frozen=True)
class LSpec:
    """An ordered collection of irrep orders (one multiplicity each;
    channel multiplicity lives on a separate tensor axis)."""

    ls: Tuple[int, ...]

    def __post_init__(self):
        if any(l < 0 for l in self.ls):
            raise ValueError(f"negative l in {self.ls}")

    @property
    def dim(self) -> int:
        return sum(dim_l(l) for l in self.ls)

    @property
    def lmax(self) -> int:
        return max(self.ls)

    def slices(self) -> Iterator[Tuple[int, slice]]:
        """Yield ``(l, slice)`` pairs into the concatenated irreps axis."""
        off = 0
        for l in self.ls:
            yield l, slice(off, off + dim_l(l))
            off += dim_l(l)

    def slice_for(self, l: int) -> slice:
        for ll, sl in self.slices():
            if ll == l:
                return sl
        raise KeyError(f"l={l} not in {self.ls}")

    def __contains__(self, l: int) -> bool:
        return l in self.ls

    def __iter__(self):
        return iter(self.ls)

    def __len__(self):
        return len(self.ls)

    def __repr__(self):
        return "+".join(f"{l}{'e' if l % 2 == 0 else 'o'}" for l in self.ls)


def lspec(*ls: int) -> LSpec:
    return LSpec(tuple(ls))


def sh_spec(lmax: int) -> LSpec:
    """Spherical-harmonics spec 0..lmax."""
    return LSpec(tuple(range(lmax + 1)))


def parity_allowed(l1: int, l2: int, l3: int) -> bool:
    """Triangle rule + SH-like parity selection."""
    return abs(l1 - l2) <= l3 <= l1 + l2 and (l1 + l2 + l3) % 2 == 0


def tp_paths(spec1: Sequence[int], spec2: Sequence[int], spec_out: Sequence[int]):
    """Enumerate allowed CG paths (l1, l2, l3) between specs, in a
    deterministic order (l3-major, matching output layout)."""
    paths = []
    for l3 in spec_out:
        for l1 in spec1:
            for l2 in spec2:
                if parity_allowed(l1, l2, l3):
                    paths.append((l1, l2, l3))
    return paths
