"""MACE-MP-0 large (Batatia et al., "A foundation model for atomistic
materials chemistry", arXiv:2401.00096; the 128-L2 model of the public
mace-mp release), on the port's CUDA kernels: hidden irreps
128x0e+128x1o+128x2e, spherical harmonics and A irreps up to l = 3,
correlation 3 (body order 4), 2 interactions, 6 Å, radial MLP 64-64-64,
89 elements.

What the port does differently from the published model: the radial basis
takes the port's p = 6 polynomial envelope (MACE-MP-0: p = 5), 10 Bessel
functions are assumed, ``avg_num_neighbors`` is that of the synthetic
Table-3 graphs at 6 Å, and the last interaction's product basis contracts
to every hidden irrep (one ``symcon_spec()`` for every layer), where the
published model keeps only its scalars.  ``REDUCED`` keeps every order of
the irreps and the correlation at 8 channels and the dataset's 10 species,
for CPU tests."""
import dataclasses

from repro_torch.core.mace import MaceConfig

CONFIG = MaceConfig(
    n_species=89,
    channels=128,
    hidden_ls=(0, 1, 2),     # 128x0e + 128x1o + 128x2e
    sh_lmax=3,               # max_ell 3
    a_ls=(0, 1, 2, 3),
    correlation=3,
    n_interactions=2,
    r_max=6.0,
    num_bessel=10,
    radial_mlp=(64, 64, 64),
    readout_mlp=16,
    avg_num_neighbors=39.8,
    impl="cuda",
    interaction_impl="cuda",
)

# edge slots per atom of a bin: the synthetic graphs have at most 57.0
# edges an atom at 6 A
EDGE_FACTOR = 64

REDUCED = dataclasses.replace(CONFIG, n_species=10, channels=8)
