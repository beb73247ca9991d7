"""Host ms per traced bin in ``serve.collate`` (padding to the bucket and
the edge blocking, numpy) and ``serve.copy_in`` (the arrays' copy to the
device).
None when nothing was traced."""
from perfbench.spans import per, spans


def read(record):
    prep = spans("serve.collate", "serve.copy_in")
    return per(sum(s.seconds for s in prep), len(spans("serve.bin")))
