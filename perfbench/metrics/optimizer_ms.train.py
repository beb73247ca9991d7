"""Host ms per traced step in ``train.optimizer`` (the mean over the bins,
clip, AdamW and the update) and ``train.ema``.
None when nothing was traced."""
from perfbench.spans import per, spans


def read(record):
    opt = spans("train.optimizer", "train.ema")
    return per(sum(s.seconds for s in opt), len(spans("train.step")))
