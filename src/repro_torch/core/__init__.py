"""Core math of the port: irreps, CG tables, edge features, specs and the MACE model."""
