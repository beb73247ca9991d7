"""The mean ``serve.queue`` of the traced requests, in ms: from ``submit``
to a worker taking the request's bin (the batcher's linger, packing and
the wait for a worker).  The traced requests are those submitted in the
profiled stretch.
None when nothing was traced."""
from perfbench.spans import per, spans


def read(record):
    queued = spans("serve.queue")
    return per(sum(s.seconds for s in queued), len(queued))
