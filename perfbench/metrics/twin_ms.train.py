"""Host ms per traced step in the second-order twins' spans
(``model.tp_twin`` and ``model.symcon_twin``, every layer's, on autograd's
thread): the double VJPs of the plain versions that differentiate the
kernels' backward.
None when nothing was traced."""
from perfbench.spans import per, spans


def read(record):
    twins = spans("model.tp_twin", "model.symcon_twin")
    return per(sum(s.seconds for s in twins), len(spans("train.step")))
