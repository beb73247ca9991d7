"""The paper's own workload: MACE CFM (§5.2 hyperparameters), on the port's
CUDA kernels.  The widths are those of the JAX package's
``configs/mace_cfm.py`` ``CONFIG`` and ``REDUCED`` (CPU-sized); the impl
names differ, and ``REDUCED`` has the dataset's 10 species (below)."""
from repro_torch.core.mace import MaceConfig

CONFIG = MaceConfig(
    n_species=89,            # MPtrj-like species coverage
    channels=128,
    hidden_ls=(0, 1),        # 128x0e + 128x1o
    sh_lmax=3,
    a_ls=(0, 1, 2, 3),
    correlation=2,           # paper §5.2 ("body order 4" counting)
    n_interactions=2,
    r_max=4.5,
    num_bessel=8,
    avg_num_neighbors=14.0,
    impl="cuda",
    interaction_impl="cuda",
)

# edge slots per atom of a bin: the synthetic graphs have at most 25.2
# edges an atom at 4.5 A
EDGE_FACTOR = 32

# The JAX REDUCED has n_species=8, but SyntheticCFMDataset draws 10 species
# (data/molecules.py N_SPECIES): XLA clamps the out-of-range embedding
# gathers of species 8 and 9 onto row 7, where torch raises.  The port's
# reduced config covers the dataset's species.
REDUCED = MaceConfig(
    n_species=10, channels=8, hidden_ls=(0, 1), sh_lmax=2, a_ls=(0, 1, 2),
    correlation=2, n_interactions=2, avg_num_neighbors=8.0, impl="cuda",
    interaction_impl="cuda",
)
