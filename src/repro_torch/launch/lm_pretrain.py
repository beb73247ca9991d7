"""LM pretraining over any assigned architecture, with the paper's bin
packing applied to sequence packing (block-diagonal attention through
segment ids).

    PYTHONPATH=src python -m repro_torch.launch.lm_pretrain --arch qwen3-14b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.lm_pretrain --device cpu --arch jamba-v0.1-52b

Port of ``examples/lm_pretrain.py``, with its flags and defaults: synthetic
documents with Pareto lengths (at most 250 tokens), packed by Algorithm 1
into ``--seq-len`` bins for ``--batch`` ranks, labels the next token inside
each document, AdamW at lr 1e-3 (``launch/lm_train_step.py``), random
weights from seed 0.  Added flags: ``--device`` (default the CUDA card,
which it refuses to run without; ``cpu`` runs on the CPU) and
``--config`` (``reduced``, the example's, or ``full``: the published
widths).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.sequence_pack import PackedBatch, pack_documents, packing_stats
from repro_torch.launch.lm_train_step import init_opt_state, make_lm_train_step
from repro_torch.launch.serve import check_tokens
from repro_torch.models.model import ArchConfig, init_params

LR = 1e-3
SEED = 0

def synth_docs(n_docs: int, vocab: int, seed: int = 0):
    """(lengths, token_fn): Pareto document lengths and per-document
    random tokens in [1, vocab)."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum((rng.pareto(1.5, size=n_docs) + 1) * 24, 250).astype(int)

    def token_fn(d, ln):
        r = np.random.default_rng(d)
        return r.integers(1, vocab, size=ln)

    return lengths, token_fn


def packed_batch(packed: PackedBatch, i: int, batch: int, cfg: ArchConfig,
                 device) -> Dict[str, torch.Tensor]:
    """Step ``i``'s batch: ``batch`` packed bins (cycling), labels the next
    token of the same document (-1 elsewhere), on ``device``."""
    n_bins = packed.tokens.shape[0]
    lo = (i * batch) % max(1, n_bins - batch + 1)
    tok = packed.tokens[lo: lo + batch]
    seg = packed.segment_ids[lo: lo + batch]
    pos = packed.positions[lo: lo + batch]
    check_tokens(tok, cfg.vocab)
    labels = np.where((seg > 0) & (np.roll(seg, -1, axis=1) == seg),
                      np.roll(tok, -1, axis=1), -1).astype(np.int32)
    out = {"tokens": tok, "labels": labels, "positions": pos, "segments": seg}
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in out.items()}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = torch.zeros((tok.shape[0], cfg.n_prefix_embeds, cfg.d_model),
                                           dtype=torch.float32, device=device)
    return out


def pretrain(args) -> List[float]:
    """Train ``args.steps`` steps; returns the losses."""
    dev = resolve_device(args.device)
    cfg = (get_config if args.config == "full" else get_reduced)(args.arch)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab} "
          f"device={dev}")

    lengths, token_fn = synth_docs(400, cfg.vocab)
    st = packing_stats(lengths, args.seq_len, args.batch)
    print(f"packing: balanced padding={st['balanced_padding']:.3f} "
          f"(fixed-count would pad {st['fixed_padding']:.3f})")
    packed = pack_documents(lengths, args.seq_len, args.batch, token_fn)

    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    m, v = init_opt_state(params)
    step = make_lm_train_step(cfg, lr=LR)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = packed_batch(packed, i, args.batch, cfg, dev)
        params, m, v, loss, _ = step(params, m, v, batch, i)
        losses.append(float(loss))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={losses[-1]:.4f}", flush=True)
    dt = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite loss: {losses}")
    print(f"{args.steps} steps in {dt:.1f}s")
    return losses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b", help=f"one of {ARCH_IDS}")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--config", choices=("reduced", "full"), default="reduced")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    pretrain(parse_args(argv))
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
