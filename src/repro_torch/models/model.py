"""One LM framework for all ten assigned architectures.

Port of the JAX package's ``models/model.py``.  A config declares a
repeating mixer pattern (jamba: 7 mamba + 1 attn; gemma3: 5 local + 1
global) and an FFN pattern (mlp / moe / none); its layers form groups of
``period`` layers, plus a shorter remainder group.  The JAX package stacks
each group kind's parameters and scans over them; here the model is an
``nn.Module`` whose blocks sit one per layer in an ``nn.ModuleList``, in
layer order, and the functions keep the JAX names:

* ``forward_train``: embedding, the layer groups (each under
  ``torch.utils.checkpoint`` when ``cfg.remat``, as the JAX scan body is
  under ``jax.checkpoint``), and a cross-entropy in sequence chunks, each
  chunk checkpointed (no ``[B, S, V]`` logits are kept);
* ``forward_prefill``: the same forward, emitting each layer's decode state;
* ``decode_step``: one token for the batch against ring-buffer KV caches
  (windowed layers hold only ``window`` slots) and O(1) recurrent states.
  Its position is a device tensor and the ring slot is computed on the
  device, so one captured CUDA graph serves every position.

Parameters are stored in ``param_dtype`` and cast to ``compute_dtype`` one
group at a time, inside the group's checkpoint (the JAX ``_cast_seg``).
Token ids must be below ``vocab``: the JAX ``jnp.take`` gives NaN rows for
larger ones, the embedding here raises.

``set_activation_sharding`` is the JAX module's activation constraint:
where the residual stream is a DTensor (parameters placed by
``launch/sharding.py``), it is redistributed to the given placements at
the start of every layer group, as the JAX scan bodies constrain it; on
plain tensors it changes nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from .attention import _project_qkv, attention_train, init_attention
from .layers import (apply_swiglu, chunked_attention, init_swiglu, make_dense, merge_dims,
                     normal, rms_norm)
from .mamba import init_mamba, init_mamba_state, mamba_decode, mamba_train
from .moe import apply_moe, init_moe
from .xlstm import (
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
    mlstm_decode,
    mlstm_train,
    slstm_decode,
    slstm_train,
)

Params = Dict[str, Any]
State = List[Dict[str, torch.Tensor]]     # one dict per layer

# Optional activation-sharding constraint (set by the launcher/dry-run):
# pins the residual stream [B, S, d] so DTensor gathers FSDP weights instead
# of resharding activations at every layer group.
_ACT_SHARDING = None


def set_activation_sharding(placements) -> None:
    """The residual stream's placements (one per mesh dim), or ``None``."""
    global _ACT_SHARDING
    _ACT_SHARDING = None if placements is None else tuple(placements)


def _lookup(tokens, table):
    """``F.embedding``.  On a DTensor table, its FSDP shards (any dim but
    the vocab's) are gathered first, as FSDP gathers a weight before use
    (DTensor's lookup over a table sharded on the embedding dim by the axis
    that also shards the tokens' batch builds a mask of the wrong shape);
    the lookup over a vocab-sharded table leaves a pending masked sum,
    which DTensor reduces once: it is reduced here, before a checkpointed
    group's recompute would reduce it again."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    vocab_only = [p if p.is_shard(0) else Replicate() for p in table.placements]
    x = F.embedding(tokens, table.redistribute(table.device_mesh, vocab_only))
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    return x


def _constrain(x):
    if _ACT_SHARDING is not None and isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, _ACT_SHARDING)
    return x


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                       # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)    # attn | swa | mamba | mlstm | slstm
    ff_pattern: Tuple[str, ...] = ("mlp",)  # mlp | moe | none
    window: Optional[int] = None            # for "swa" mixers
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    n_experts: int = 0
    top_k: int = 0
    n_prefix_embeds: int = 0                # VLM stub: patch-embedding slots
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 2048
    attn_chunk: int = 1024
    norm_eps: float = 1e-6
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    remat: bool = True
    subquadratic: bool = False              # eligible for long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def period(self) -> int:
        return math.lcm(len(self.pattern), len(self.ff_pattern))

    def layer_kinds(self, i: int) -> Tuple[str, str]:
        return (
            self.pattern[i % len(self.pattern)],
            self.ff_pattern[i % len(self.ff_pattern)],
        )

    @property
    def segments(self) -> List[Tuple[int, int]]:
        """[(period_len, n_repeats)]: full groups + an optional remainder."""
        p = self.period
        out = []
        if self.n_layers // p:
            out.append((p, self.n_layers // p))
        if self.n_layers % p:
            out.append((self.n_layers % p, 1))
        return out

    def groups(self) -> List[range]:
        """The layer indices of each group, in layer order: ``reps`` groups
        of ``period_len`` layers per segment (the JAX scan trips)."""
        out, layer = [], 0
        for plen, reps in self.segments:
            for _ in range(reps):
                out.append(range(layer, layer + plen))
                layer += plen
        return out

    def param_count(self) -> int:
        """Analytic parameter count (the roofline's 6·N·D)."""
        d, f = self.d_model, self.d_ff
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        total = 2 * self.vocab * d  # embed + head
        for i in range(self.n_layers):
            mixer, ff = self.layer_kinds(i)
            if mixer in ("attn", "swa"):
                total += d * dh * (hq + 2 * hkv) + hq * dh * d
            elif mixer == "mamba":
                di = self.mamba_expand * d
                total += d * 2 * di + di * (2 * self.mamba_d_state + d // 16) + (
                    d // 16
                ) * di + 2 * di * d // self.mamba_expand  # approx in/out
            elif mixer == "mlstm":
                total += 5 * d * d
            elif mixer == "slstm":
                total += 4 * d * d + 2 * d * int(4 * d / 3)
            if ff == "mlp":
                total += 3 * d * f
            elif ff == "moe":
                total += d * self.n_experts + 3 * self.n_experts * d * f
        return total

    def active_param_count(self) -> int:
        """Per-token activated params (MoE counts top_k experts)."""
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        for i in range(self.n_layers):
            _, ff = self.layer_kinds(i)
            if ff == "moe":
                total -= 3 * (self.n_experts - self.top_k) * d * f
        # embeddings are lookups, not matmuls; keep the head only
        total -= self.vocab * d
        return total


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: ``norm1``, the mixer's parameters ``mix``, and for an FFN
    layer ``norm2`` and ``ff``, under the JAX parameter names."""

    def __init__(self, mixer: str, ff: str, tree: Mapping[str, Any]):
        super().__init__()
        self.mixer, self.ff_kind = mixer, ff
        self.norm1 = nn.Parameter(tree["norm1"])
        self.mix = nn.ParameterDict(tree["mix"])
        if ff != "none":
            self.norm2 = nn.Parameter(tree["norm2"])
            self.ff = nn.ParameterDict(tree["ff"])

    def cast(self, dtype) -> Params:
        """The block's parameters as a nested dict in ``dtype``."""
        p: Params = {"norm1": self.norm1.to(dtype),
                     "mix": {k: v.to(dtype) for k, v in self.mix.items()}}
        if self.ff_kind != "none":
            p["norm2"] = self.norm2.to(dtype)
            p["ff"] = {k: v.to(dtype) for k, v in self.ff.items()}
        return p


class LM(nn.Module):
    """The parameters of one architecture: ``embed`` [V, d], ``head``
    [d, V], ``final_norm`` [d] and ``layers`` (one :class:`Block` per
    layer).  ``tree`` is ``{"embed", "head", "final_norm", "layers": [per
    layer {"norm1", "mix": {...}, "norm2", "ff": {...}}]}``."""

    def __init__(self, cfg: ArchConfig, tree: Mapping[str, Any]):
        super().__init__()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a {cfg.n_layers}-layer config")
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.head = nn.Parameter(tree["head"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(
            Block(*cfg.layer_kinds(i), t) for i, t in enumerate(tree["layers"]))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(gen, cfg: ArchConfig, mixer: str, ff: str, device) -> Params:
    dt = cfg.param_dtype
    p: Params = {"norm1": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
    if mixer in ("attn", "swa"):
        p["mix"] = init_attention(gen, cfg, dt, device)
    elif mixer == "mamba":
        p["mix"] = init_mamba(gen, cfg, dt, device)
    elif mixer == "mlstm":
        p["mix"] = init_mlstm(gen, cfg, dt, device)
    elif mixer == "slstm":
        p["mix"] = init_slstm(gen, cfg, dt, device)
    else:
        raise ValueError(mixer)
    if ff == "mlp":
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ff"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device)
    elif ff == "moe":
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        p["ff"] = init_moe(gen, cfg, dt, device)
    elif ff != "none":
        raise ValueError(ff)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None) -> LM:
    """Random parameters from ``gen`` (on ``device``, by default the
    generator's), with the JAX package's shapes and scales."""
    device = gen.device if device is None else torch.device(device)
    dt = cfg.param_dtype
    tree = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), dt, device) * 0.02,
        "head": make_dense(gen, cfg.d_model, cfg.vocab, dt, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "layers": [_init_block(gen, cfg, *cfg.layer_kinds(i), device)
                   for i in range(cfg.n_layers)],
    }
    return LM(cfg, tree)


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------


def _apply_ff(p: Params, cfg: ArchConfig, ff: str, x):
    """(x + FFN(norm2(x)), aux)."""
    aux = x.new_zeros(())
    if ff == "none":
        return x, aux
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ff == "moe":
        y, aux = apply_moe(p["ff"], cfg, h, capacity_factor=cfg.moe_capacity_factor,
                           group_size=cfg.moe_group_size)
    else:
        y = apply_swiglu(p["ff"], h)
    return x + y, aux


def _apply_block(p: Params, cfg: ArchConfig, mixer: str, ff: str, x, positions, segments):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer == "attn":
        y = attention_train(p["mix"], cfg, h, positions, segments, None)
    elif mixer == "swa":
        y = attention_train(p["mix"], cfg, h, positions, segments, cfg.window)
    elif mixer == "mamba":
        y = mamba_train(p["mix"], cfg, h)
    elif mixer == "mlstm":
        y = mlstm_train(p["mix"], cfg, h)
    elif mixer == "slstm":
        y = slstm_train(p["mix"], cfg, h)
    return _apply_ff(p, cfg, ff, x + y)


def _run_segments(cfg: ArchConfig, params: LM, x, positions, segments, train: bool):
    """Apply every layer group.  Returns (x, aux_total)."""
    aux_total = x.new_zeros(())
    for group in cfg.groups():
        def run(x, group=group):
            x = _constrain(x)
            aux = x.new_zeros(())
            for i in group:
                blk = params.layers[i]
                x, a = _apply_block(blk.cast(cfg.compute_dtype), cfg, blk.mixer, blk.ff_kind,
                                    x, positions, segments)
                aux = aux + a
            return x, aux

        if cfg.remat and train and torch.is_grad_enabled():
            x, a = checkpoint(run, x, use_reentrant=False)
        else:
            x, a = run(x)
        aux_total = aux_total + a
    return x, aux_total


def _embed(cfg: ArchConfig, params: LM, tokens, prefix_embeds):
    x = _lookup(tokens, params.embed).to(cfg.compute_dtype)
    if cfg.n_prefix_embeds and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x[:, prefix_embeds.shape[1]:]], dim=1)
    return x


def _chunk_loss(nll_sum, n_valid, xh, lab, head):
    logits = (xh @ head).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    idx = torch.clamp(lab, min=0).long()
    if isinstance(logits, DTensor):
        # DTensor's gather over a vocab-sharded dim leaves a masked partial
        # it cannot reduce; the JAX one-hot contraction picks the same logit
        hot = idx[..., None] == torch.arange(logits.shape[-1], device=idx.device)
        gold = torch.sum(logits * hot.to(logits.dtype), dim=-1)
    else:
        # the JAX one-hot contraction picks the same logit exactly
        gold = logits.gather(-1, idx[..., None])[..., 0]
    valid = (lab >= 0).to(torch.float32)
    nll = (logz - gold) * valid
    return nll_sum + nll.sum(), n_valid + valid.sum()


def forward_train(
    params: LM,
    cfg: ArchConfig,
    batch: Mapping[str, torch.Tensor],
    *,
    loss_chunk: int = 512,
    aux_weight: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,S], labels [B,S] (-1 = pad), positions [B,S],
    optional segments [B,S], optional prefix_embeds [B,P,d]."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    segments = batch.get("segments")
    x = _embed(cfg, params, tokens, batch.get("prefix_embeds"))
    x, aux = _run_segments(cfg, params, x, positions, segments, train=True)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)

    labels = batch["labels"]
    head = params.head.to(cfg.compute_dtype)

    # chunked cross-entropy: never materialise [B, S, V]; each chunk's
    # logits are recomputed in the backward
    n_chunks = -(-S // loss_chunk)
    pad = n_chunks * loss_chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for c in range(n_chunks):
        sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
        args = (nll_sum, n_valid, x[:, sl], labels[:, sl], head)
        if remat:
            nll_sum, n_valid = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            nll_sum, n_valid = _chunk_loss(*args)
    nll = nll_sum / torch.clamp(n_valid, min=1.0)
    aux = aux.to(torch.float32)
    loss = nll + aux_weight * aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# prefill (a forward that also emits the decode-ready state)
# ---------------------------------------------------------------------------


def _apply_block_collect(p: Params, cfg: ArchConfig, mixer: str, ff: str, x, positions):
    """Like _apply_block, without segments, but returns the mixer's
    decode-ready state."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer == "attn":
        y, st = attention_train(p["mix"], cfg, h, positions, None, None, True)
    elif mixer == "swa":
        y, st = attention_train(p["mix"], cfg, h, positions, None, cfg.window, True)
    elif mixer == "mamba":
        y, st = mamba_train(p["mix"], cfg, h, return_state=True)
    elif mixer == "mlstm":
        y, st = mlstm_train(p["mix"], cfg, h, return_state=True)
    elif mixer == "slstm":
        y, st = slstm_train(p["mix"], cfg, h, return_state=True)
    x, _ = _apply_ff(p, cfg, ff, x + y)
    return x, st


def forward_prefill(
    params: LM,
    cfg: ArchConfig,
    tokens: torch.Tensor,                      # [B, S]
    prefix_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """Process a full prompt; returns (last-token logits [B, V] float32, the
    decode state in ``init_decode_state``'s layout with ``max_seq = S``)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    x = _embed(cfg, params, tokens, prefix_embeds)
    state: State = []
    for group in cfg.groups():
        x = _constrain(x)
        for i in group:
            blk = params.layers[i]
            x, st = _apply_block_collect(blk.cast(cfg.compute_dtype), cfg, blk.mixer,
                                         blk.ff_kind, x, positions)
            state.append(st)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x[:, -1] @ params.head.to(cfg.compute_dtype)).to(torch.float32)
    return logits, state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                      device=None) -> State:
    """Per-layer decode states.  Windowed attention allocates only
    ``window`` KV slots (a ring buffer); recurrent mixers carry O(1)
    states."""
    dt = dtype or cfg.compute_dtype
    state: State = []
    for i in range(cfg.n_layers):
        mixer, _ = cfg.layer_kinds(i)
        if mixer in ("attn", "swa"):
            slots = max_seq if mixer == "attn" or cfg.window is None else min(
                max_seq, cfg.window)
            kv = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
            one = {
                "k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device),
                "pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
            }
        elif mixer == "mamba":
            one = init_mamba_state(cfg, batch, dt, device)
        elif mixer == "mlstm":
            one = init_mlstm_state(cfg, batch, device)
        elif mixer == "slstm":
            one = init_slstm_state(cfg, batch, dt, device)
        state.append(one)
    return state


def decode_step(
    params: LM,
    state: State,
    cfg: ArchConfig,
    tokens: torch.Tensor,   # [B, 1]
    pos,                    # int or int32 scalar tensor: the current absolute position
) -> Tuple[torch.Tensor, State]:
    """One token for the whole batch.  Returns (logits [B, V], new_state)."""
    x = _lookup(tokens, params.embed).to(cfg.compute_dtype)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    new_state: State = []
    first = {g[0] for g in cfg.groups()}
    for i, (blk, s) in enumerate(zip(params.layers, state)):
        if i in first:
            x = _constrain(x)
        p = blk.cast(cfg.compute_dtype)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if blk.mixer in ("attn", "swa"):
            window = cfg.window if blk.mixer == "swa" else None
            slot = torch.remainder(pos, s["k"].shape[1])
            y, s = _attn_decode_ring(p["mix"], cfg, h, pos, slot, s, window)
        elif blk.mixer == "mamba":
            y, s = mamba_decode(p["mix"], cfg, h, s)
        elif blk.mixer == "mlstm":
            y, s = mlstm_decode(p["mix"], cfg, h, s)
        elif blk.mixer == "slstm":
            y, s = slstm_decode(p["mix"], cfg, h, s)
        x, _ = _apply_ff(p, cfg, blk.ff_kind, x + y.to(x.dtype))
        new_state.append(s)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x[:, 0] @ params.head.to(cfg.compute_dtype)).to(torch.float32)
    return logits, new_state


def _attn_decode_ring(p, cfg, x, pos, slot, cache, window):
    """Ring-buffer KV decode: write (k, v, pos) at ``slot`` (a device
    tensor), mask by the stored absolute positions (handles full and
    windowed caches)."""
    B = x.shape[0]
    positions = pos.expand(B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    if isinstance(cache["k"], DTensor):
        # no DTensor strategy for index_copy (torch 2.11): the same write
        # as a select over the slots
        hit = torch.arange(cache["k"].shape[1], device=slot.device) == slot
        ck = torch.where(hit[None, :, None, None], k.to(cache["k"].dtype), cache["k"])
        cv = torch.where(hit[None, :, None, None], v.to(cache["v"].dtype), cache["v"])
        cp = torch.where(hit[None, :], positions, cache["pos"])
    else:
        at = slot.reshape(1).long()
        ck = cache["k"].index_copy(1, at, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy(1, at, v.to(cache["v"].dtype))
        cp = cache["pos"].index_copy(1, at, positions)
    out = chunked_attention(
        q, ck, cv,
        q_positions=positions, kv_positions=cp, kv_valid=cp >= 0,
        window=window, chunk=cfg.attn_chunk,
    )
    out = merge_dims(out, 2, 2) @ p["wo"]
    return out, {"k": ck, "v": cv, "pos": cp}
