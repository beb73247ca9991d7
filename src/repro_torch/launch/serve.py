"""Batched LM serving: greedy prefill and decode over ring-buffer KV caches,
one CUDA graph each.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --config full --arch granite-3-2b \\
        --requests 20 --batch 8 --prompt-len 512 --max-new 64

Port of the JAX package's ``launch/serve.py`` (which also covers
``examples/serve_lm.py``'s prefill-and-greedy loop), with its flags and
defaults: random weights from a seed, ``--requests`` random prompts of
``--prompt-len`` tokens served ``--batch`` at a time, ``--max-new`` greedy
tokens each.  The tail batch is padded with all-zero prompts to the full
batch shape, so the engine serves one shape: on the card
:class:`~repro_torch.serve.lm_engine.LMServeEngine` captures prefill and
decode once each, and the run asserts a census of exactly one graph each
after the padded tail (0 each on the CPU, which runs the same buffers
eagerly).

Added flags: ``--device`` (default the CUDA card, which it refuses to run
without; ``cpu`` runs on the CPU) and ``--config``: ``reduced`` (default,
the JAX entry point's) or ``full``, the published widths, served with
``param_dtype=bfloat16`` so that no decode step re-casts float32 weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.models.model import ArchConfig, init_params
from repro_torch.serve.lm_engine import LMServeEngine

SEED = 0    # the weights' generator and the prompts', as the JAX entry point's PRNGKey(0)

def serving_config(arch: str, config: str) -> ArchConfig:
    if config == "full":
        return dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16)
    return get_reduced(arch)


def check_tokens(tokens: np.ndarray, vocab: int) -> None:
    """Token ids must index the embedding (the JAX ``jnp.take`` would give
    NaN rows; the port's embedding raises, and on the card an out-of-range
    id is a device-side assert)."""
    if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab):
        raise ValueError(f"token ids span [{tokens.min()}, {tokens.max()}], vocab {vocab}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(args) -> Dict[str, Any]:
    """Run the loop; returns the stats, the engine, each request's prompt
    ([requests, prompt_len]) and its tokens ([requests, max_new])."""
    dev = resolve_device(args.device)
    cfg = serving_config(args.arch, args.config)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = LMServeEngine(params, cfg, args.batch, args.prompt_len, device=dev)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    prompts_all = [rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
                   for _ in range(args.requests)]
    pending = list(prompts_all)
    outputs, prefill_s, decode_s = [], [], []
    done = 0
    t0 = time.perf_counter()
    while pending:
        batch, pending = pending[: args.batch], pending[args.batch:]
        n_real = len(batch)
        # pad the tail batch to the full batch shape: one shape, one graph each
        batch = batch + [np.zeros(args.prompt_len, np.int32)] * (args.batch - n_real)
        prompts = np.stack(batch)
        check_tokens(prompts, cfg.vocab)
        prompts = torch.from_numpy(prompts).to(dev)
        ta = time.perf_counter()
        toks = [engine.prefill(prompts)[0].clone()]
        _sync(dev)
        tb = time.perf_counter()
        for i in range(args.max_new - 1):
            toks.append(engine.decode(args.prompt_len + i)[0].clone())
        out = torch.cat(toks, dim=1).cpu().numpy()
        tc = time.perf_counter()
        prefill_s.append(tb - ta)
        decode_s.append(tc - tb)
        outputs.append(out[:n_real])
        done += n_real
        print(f"served {done}/{args.requests} "
              f"({done * args.max_new / (time.perf_counter() - t0):.1f} tok/s)", flush=True)
    wall = time.perf_counter() - t0
    census = engine.compile_census()
    want = 1 if dev.type == "cuda" else 0
    if census != {"prefill": want, "decode": want}:
        raise AssertionError(f"serve loop captured {census}: the tail batch hit a new shape")
    steps = max(args.max_new - 1, 1)
    return {
        "stats": {
            "arch": cfg.name, "device": str(dev), "requests": args.requests,
            "batch": args.batch, "prompt_len": args.prompt_len, "max_new": args.max_new,
            "tokens_per_s": args.requests * args.max_new / wall, "wall_s": wall,
            "warmup_s": warmup_s, "prefill_ms": [1e3 * s for s in prefill_s],
            "decode_ms_per_token": [1e3 * s / steps for s in decode_s],
            "census": census,
        },
        "engine": engine,
        "prompts": np.stack(prompts_all),
        "tokens": np.concatenate(outputs),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--config", choices=("reduced", "full"), default="reduced")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    res = serve(parse_args(argv))
    res["engine"].close()
    st = res["stats"]
    print(f"census {st['census']}; prefill ms per batch {st['prefill_ms']}; decode ms per "
          f"token {[round(x, 3) for x in st['decode_ms_per_token']]}")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
