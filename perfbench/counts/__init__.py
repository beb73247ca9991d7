"""The benchmark's counts of work: model FLOPs of a bin from its real atoms
and edges (``model.py``), each CUDA kernel's bytes and operations and its
roofline bound (``kernels.py``), and the card's published peaks."""
