"""Algorithm 1 applied to LM sequence packing (a copy of the JAX package's
``data/sequence_pack.py`` on the port's ``core/binpack.py``).

Variable-length documents are the transformer analogue of variable-size
molecular graphs: packing documents into fixed-token bins with balanced
loads cuts both padding and data-parallel stragglers.  The packer is the
same ``create_balanced_batches``; only the collation differs: packed
documents get segment ids for block-diagonal (intra-document) attention.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.binpack import balance_metrics, create_balanced_batches, fixed_count_batches


@dataclasses.dataclass
class PackedBatch:
    tokens: np.ndarray       # [n_bins, seq_len] int32 (0 = pad)
    segment_ids: np.ndarray  # [n_bins, seq_len] int32 (0 = pad, docs 1..)
    positions: np.ndarray    # [n_bins, seq_len] int32 (per-doc positions)
    doc_ids: List[List[int]]


def pack_documents(
    doc_lengths: Sequence[int],
    seq_len: int,
    n_ranks: int,
    token_fn=None,
) -> PackedBatch:
    """Pack docs into [n_bins, seq_len] with Algorithm 1.  Without
    ``token_fn`` document ``d`` is the token ``d % 32000 + 1`` repeated,
    which exceeds a small vocabulary: callers with one pass ``token_fn``."""
    packed = create_balanced_batches(doc_lengths, seq_len, n_ranks)
    n_bins = packed.n_bins
    tokens = np.zeros((n_bins, seq_len), np.int32)
    seg = np.zeros((n_bins, seq_len), np.int32)
    pos = np.zeros((n_bins, seq_len), np.int32)
    for b, docs in enumerate(packed.bins):
        off = 0
        for s, d in enumerate(docs):
            ln = int(doc_lengths[d])
            tokens[b, off : off + ln] = (
                token_fn(d, ln) if token_fn else np.full(ln, d % 32000 + 1)
            )
            seg[b, off : off + ln] = s + 1
            pos[b, off : off + ln] = np.arange(ln)
            off += ln
    return PackedBatch(tokens, seg, pos, [list(b) for b in packed.bins])


def packing_stats(doc_lengths: Sequence[int], seq_len: int, n_ranks: int) -> Dict[str, float]:
    """Padding + balance: Algorithm 1 against the fixed-count baseline."""
    ours = balance_metrics(
        create_balanced_batches(doc_lengths, seq_len, n_ranks), n_ranks
    )
    mean_len = float(np.mean(doc_lengths))
    docs_per_seq = max(1, int(seq_len // max(mean_len, 1)))
    base = balance_metrics(
        fixed_count_batches(doc_lengths, docs_per_seq, n_ranks, shuffle=True), n_ranks
    )
    return {
        "balanced_padding": ours.padding_fraction,
        "balanced_straggler": ours.straggler_ratio,
        "fixed_padding": 1.0 - min(1.0, base.mean_load / seq_len),
        "fixed_straggler": base.straggler_ratio,
    }
