"""The benchmark's plain reference: MACE in float32 PyTorch (``mace.py``)
on its own copy of the CG tables (``cg.py``), the training step
(``optim.py``) and the numbers that decide ``correct`` (``check.py``).
Nothing here imports the program under test."""
