"""Kernel registry, the CUDA build, and the kernel wrappers of the port."""
import torch


def refuse_third_order(op: str) -> None:
    """A kernel op's second-order rule runs its twin's autodiff on detached
    copies, so its result carries no graph: refuse a backward that is asked
    to build one (a third derivative)."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{op}: only first and second derivatives are implemented "
            "(the second-order rule does not build a graph)"
        )
