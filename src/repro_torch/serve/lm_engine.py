"""LM serving engine: greedy prefill and decode at one (batch, prompt_len)
shape, one captured CUDA graph for each.

The counterpart of the JAX serve loop's two jitted programs
(``launch/serve.py``: ``prefill`` and ``step``, each compiled once): on the
card :meth:`LMServeEngine.warmup` captures ``forward_prefill`` at
``(batch, prompt_len)`` and ``decode_step`` at ``(batch, slots)`` with
:func:`serve.engine.capture_graph` (side-stream warm-up, a pool per graph),
over static buffers: the prompt tokens, the last token, the position (an
int32 device tensor, filled before each replay; the ring slot is computed
from it on the device) and the decode state, which each graph overwrites.
Each graph also writes the greedy next token into the token buffer, so a
decode replay reads the previous replay's token.  A prompt batch of another
shape raises; it never triggers a capture.  ``compile_census()`` counts the
graphs captured: exactly 1 and 1 on the card after warm-up, 0 on the CPU,
where the same buffers run eagerly.

The decode state has ``prompt_len`` slots for global attention, as the JAX
``forward_prefill`` builds it, so decoding past the prompt overwrites the
oldest prompt positions (the reference's ring buffer; see ``decode``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.bridge import resolve_device
from repro_torch.models.model import LM, ArchConfig, decode_step, forward_prefill, init_decode_state

from .engine import capture_graph


def _copy_state(dst, src) -> None:
    for d, s in zip(dst, src):
        for k, buf in d.items():
            buf.copy_(s[k])


class LMServeEngine:
    """* ``prefill(prompts)`` -> (next tokens [B, 1], logits [B, V])
    * ``decode(pos)``      -> the same for the token at ``pos``
    * ``warmup()`` / ``compile_census()`` / ``close()``

    Every result is a static buffer, overwritten by the next call.
    ``eager=True`` runs the same computation without the graphs."""

    def __init__(self, params: LM, cfg: ArchConfig, batch: int, prompt_len: int,
                 *, device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.batch, self.prompt_len = batch, prompt_len
        dev = self.device
        self.tokens = torch.zeros((batch, prompt_len), dtype=torch.int32, device=dev)
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.state = init_decode_state(cfg, batch, prompt_len, device=dev)
        self.logits = torch.zeros((batch, cfg.vocab), dtype=torch.float32, device=dev)
        self._graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._captures = {"prefill": 0, "decode": 0}
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    # ------------------------------ programs -------------------------------

    @torch.no_grad()
    def _prefill(self) -> None:
        logits, state = forward_prefill(self.params, self.cfg, self.tokens)
        self._emit(logits, state)

    @torch.no_grad()
    def _decode(self) -> None:
        logits, state = decode_step(self.params, self.state, self.cfg, self.tok, self.pos)
        self._emit(logits, state)

    def _emit(self, logits, state) -> None:
        _copy_state(self.state, state)
        self.logits.copy_(logits)
        self.tok.copy_(torch.argmax(logits, dim=-1, keepdim=True))

    _PROGRAMS = {"prefill": _prefill, "decode": _decode}

    # ------------------------------ lifecycle ------------------------------

    def warmup(self) -> None:
        """On the card, capture both programs (each run once eagerly first);
        on the CPU, nothing."""
        if self._stream is None:
            return
        for name, fn in self._PROGRAMS.items():
            if name in self._graphs:
                raise RuntimeError(f"{name} is already captured")
            self._graphs[name], _, _, _ = capture_graph(
                lambda fn=fn: fn(self), self._stream, self.device)
            self._captures[name] += 1

    def close(self) -> None:
        for graph in self._graphs.values():
            graph.reset()
        self._graphs = {}
        if self._stream is not None:
            torch.cuda.empty_cache()

    def compile_census(self) -> Dict[str, int]:
        """Graphs captured per program: 1 each on the card after
        :meth:`warmup`, whatever was served; 0 on the CPU."""
        return dict(self._captures)

    # ------------------------------- compute -------------------------------

    def _run(self, name: str, eager: bool) -> None:
        if self._stream is None or eager:
            self._PROGRAMS[name](self)
            return
        graph = self._graphs.get(name)
        if graph is None:
            raise RuntimeError(f"{name} has no captured graph: call warmup()")
        graph.replay()

    def prefill(self, prompts: torch.Tensor, *, eager: bool = False):
        """Process ``prompts`` [batch, prompt_len] (int32); returns the
        greedy next tokens [B, 1] and the last position's logits."""
        if tuple(prompts.shape) != tuple(self.tokens.shape) or prompts.dtype != torch.int32:
            raise ValueError(
                f"prompts are {prompts.dtype} {tuple(prompts.shape)}; this engine serves "
                f"int32 {tuple(self.tokens.shape)}")
        self.tokens.copy_(prompts)
        self._run("prefill", eager)
        return self.tok, self.logits

    def decode(self, pos: int, *, eager: bool = False):
        """Feed the last token at absolute position ``pos``; returns the
        greedy next tokens and the logits.  Global attention has
        ``prompt_len`` slots, so ``pos`` overwrites slot ``pos %
        prompt_len``: the reference decodes against a window of
        ``prompt_len`` positions."""
        self.pos.fill_(pos)
        self._run("decode", eager)
        return self.tok, self.logits
