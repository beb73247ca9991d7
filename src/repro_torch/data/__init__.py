"""Numpy data pipeline of the port: synthetic molecules, collation, edge blocking."""
from .blocking import EdgeBlocking, block_edges  # noqa: F401
from .collate import BinShape, collate_bin  # noqa: F401
from .molecules import Molecule, SyntheticCFMDataset  # noqa: F401
