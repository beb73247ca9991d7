"""Host ms per traced step blocked on the device in ``train.sync`` (the
read of the step's metrics, which waits for the step's work).
None when nothing was traced."""
from perfbench.spans import per, spans


def read(record):
    return per(sum(s.seconds for s in spans("train.sync")), len(spans("train.step")))
