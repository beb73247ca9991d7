"""MACE in plain PyTorch, float32: the benchmark's reference.

The same mathematics as the port's model (Batatia et al., NeurIPS 2022, as
the paper's §5.2 configures it), written again without kernels, tables of
the program, padding or batching tricks:

* real spherical harmonics of the edge vectors, as polynomials
  (``cg.real_sh_polys``); the Bessel basis times the p = 6 polynomial
  cutoff; a SiLU radial MLP giving one weight per (path, channel);
* per layer: per-l linear up; the channelwise tensor product as one dense
  CG einsum per path, summed onto the receivers over ``avg_num_neighbors``;
  per-l linear; the symmetric contraction as a dense contraction with the
  generalised CG tensor ``U`` of each (L, nu); per-l linear; the
  species-dependent skip from the layer's input; a linear readout (an MLP
  after the last layer);
* the energy of a graph, its atoms' sums plus the per-species ``e0``; the
  forces as minus its positions-gradient by autograd;
* the weighted loss, and the clip, AdamW and EMA update (``optim.py``).

Graphs are given unpadded.  The parameters are a nested dict with the
port's keys, so the benchmark hands the same tensors to both sides.  This
module imports nothing of the program: its tables come from its own copy of
the CG code (``cg.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cg

Params = Dict[str, object]

MODEL_FIELDS = ("n_species", "channels", "hidden_ls", "sh_lmax", "a_ls", "correlation",
                "n_interactions", "r_max", "num_bessel", "radial_mlp", "readout_mlp",
                "avg_num_neighbors")


@dataclasses.dataclass(frozen=True)
class Config:
    n_species: int
    channels: int
    hidden_ls: Tuple[int, ...]
    sh_lmax: int
    a_ls: Tuple[int, ...]
    correlation: int
    n_interactions: int
    r_max: float
    num_bessel: int
    radial_mlp: Tuple[int, ...]
    readout_mlp: int
    avg_num_neighbors: float

    @staticmethod
    def from_fields(fields: Dict) -> "Config":
        return Config(**{f: tuple(fields[f]) if isinstance(fields[f], list) else fields[f]
                         for f in MODEL_FIELDS})

    def h_ls(self, layer: int) -> Tuple[int, ...]:
        """Irreps of the features entering interaction ``layer``."""
        return (0,) if layer == 0 else self.hidden_ls

    def paths(self, layer: int) -> List[Tuple[int, int, int]]:
        """(l_sh, l_h, l_a) CG paths, output-major."""
        return [(l1, l2, l3) for l3 in self.a_ls for l1 in range(self.sh_lmax + 1)
                for l2 in self.h_ls(layer) if cg.parity_ok(l1, l2, l3)]

    def symcon_terms(self) -> List[Tuple[int, int, int]]:
        """(L, nu, n_paths) of every term with a nonempty path space."""
        out = []
        for L in self.hidden_ls:
            for nu in range(1, self.correlation + 1):
                n = cg.u_tensor(tuple(self.a_ls), L, nu).shape[-1]
                if n > 0:
                    out.append((L, nu, n))
        return out


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Matrix products in TF32 (the control) or in float32 (the reference,
    and the default), whatever the process had set; restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _dim(ls: Sequence[int]) -> int:
    return sum(2 * l + 1 for l in ls)


def _slices(ls: Sequence[int]) -> List[Tuple[int, slice]]:
    out, off = [], 0
    for l in ls:
        out.append((l, slice(off, off + 2 * l + 1)))
        off += 2 * l + 1
    return out


# ----------------------------- parameters ----------------------------------


def param_layout(cfg: Config) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Flat ``"a/b/c"`` key -> (shape, scale): the leaf is a standard normal
    draw times ``scale`` (0: zeros), the port's shapes and scales."""
    k = cfg.channels
    out: Dict[str, Tuple[Tuple[int, ...], float]] = {
        "embed": ((cfg.n_species, k), 1 / math.sqrt(cfg.n_species)),
        "e0": ((cfg.n_species,), 0.0),
    }

    def linear(prefix, ls):
        for i, l in enumerate(ls):
            out[f"{prefix}/l{l}_{i}"] = ((k, k), 1 / math.sqrt(k))

    def mlp(prefix, sizes):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out[f"{prefix}/w{i}"] = ((a, b), 1 / math.sqrt(a))
            out[f"{prefix}/b{i}"] = ((b,), 0.0)

    for t in range(cfg.n_interactions):
        p = f"layer_{t}"
        linear(f"{p}/lin_up", cfg.h_ls(t))
        mlp(f"{p}/radial", (cfg.num_bessel, *cfg.radial_mlp, len(cfg.paths(t)) * k))
        linear(f"{p}/lin_a", cfg.a_ls)
        for L, nu, n in sorted(cfg.symcon_terms()):
            out[f"{p}/symcon/w_L{L}_nu{nu}"] = ((cfg.n_species, k, n), 1 / math.sqrt(n))
        linear(f"{p}/lin_msg", cfg.hidden_ls)
        for i, l in enumerate(cfg.h_ls(t)):
            if l in cfg.hidden_ls:
                out[f"{p}/skip/l{l}_{i}"] = ((cfg.n_species, k, k), 1 / math.sqrt(k))
        if t < cfg.n_interactions - 1:
            out[f"{p}/readout"] = ((k, 1), 1 / math.sqrt(k))
        else:
            mlp(f"{p}/readout_mlp", (k, cfg.readout_mlp, 1))
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Params:
    tree: Params = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def flat_items(tree: Params, prefix: str = ""):
    """(flat key, leaf) pairs in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat_items(v, key)
        else:
            yield key, v


def init_params(cfg: Config, seed: int, device) -> Params:
    """The parameters of a run, drawn from ``seed`` on ``device`` in one
    normal draw, split into leaves and scaled."""
    layout = param_layout(cfg)
    total = sum(math.prod(s) for s, _ in layout.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, (shape, scale) in layout.items():
        n = math.prod(shape)
        out[key] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    return nest(out)


# ----------------------------- the model -----------------------------------


@functools.lru_cache(maxsize=None)
def _table(kind: str, args: Tuple, device: torch.device) -> torch.Tensor:
    if kind == "cg":
        arr = cg.real_cg(*args)
    elif kind == "u":
        arr = cg.u_tensor(*args)
    else:
        arr = np.asarray(cg.real_sh_polys(*args))
    return torch.as_tensor(arr, dtype=torch.float32, device=device)


def spherical_harmonics(lmax: int, vec: torch.Tensor) -> torch.Tensor:
    """Real SH, l = 0..lmax, of the directions of ``vec`` [E, 3]."""
    n2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    v = vec / torch.sqrt(torch.clamp(n2, min=1e-18))
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    blocks = []
    for l in range(lmax + 1):
        monos = torch.stack([x ** a * y ** b * z ** c
                             for (a, b, c) in cg.monomial_exponents(l)], dim=-1)
        blocks.append(monos @ _table("sh", (l,), vec.device).T)
    return torch.cat(blocks, dim=-1)


def radial_basis(r: torch.Tensor, r_max: float, num: int, p: int = 6) -> torch.Tensor:
    """Bessel functions times the polynomial cutoff envelope: [E, num]."""
    n = torch.arange(1, num + 1, dtype=r.dtype, device=r.device)
    x = torch.clamp(r, min=1e-9)[:, None]
    bessel = math.sqrt(2.0 / r_max) * torch.sin(n * math.pi * x / r_max) / x
    u = r / r_max
    env = (1.0 - (p + 1.0) * (p + 2.0) / 2.0 * u ** p + p * (p + 2.0) * u ** (p + 1)
           - p * (p + 1.0) / 2.0 * u ** (p + 2)) * (u < 1.0).to(r.dtype)
    return bessel * env[:, None]


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(p) // 2
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = F.silu(x)
    return x


def linear(p: Params, x: torch.Tensor, ls: Sequence[int]) -> torch.Tensor:
    """Channel mixing per l block: x [N, k, dim(ls)]."""
    return torch.cat([torch.einsum("nkd,kq->nqd", x[:, :, sl], p[f"l{l}_{i}"])
                      for i, (l, sl) in enumerate(_slices(ls))], dim=-1)


def tensor_product(cfg: Config, layer: int, Y, h_send, R) -> torch.Tensor:
    """Per-edge messages [E, k, dim(a_ls)]: for each path, the dense CG
    contraction of Y's l1 block with h's l2 block, times the path's weight."""
    sh_sl = dict(_slices(range(cfg.sh_lmax + 1)))
    h_sl = dict(_slices(cfg.h_ls(layer)))
    blocks = {l3: 0 for l3 in cfg.a_ls}
    for p, (l1, l2, l3) in enumerate(cfg.paths(layer)):
        C = _table("cg", (l1, l2, l3), Y.device)
        blk = torch.einsum("abc,ea,ekb->ekc", C, Y[:, sh_sl[l1]], h_send[:, :, h_sl[l2]])
        blocks[l3] = blocks[l3] + blk * R[:, p, :, None]
    return torch.cat([blocks[l3] for l3 in cfg.a_ls], dim=-1)


def symmetric_contraction(cfg: Config, A: torch.Tensor, species, weights) -> torch.Tensor:
    """B [N, k, dim(hidden)] = sum over (L, nu) of W_eta . U[...M eta] . A^nu,
    with the dense U of each term; the powers of A are contracted one at a
    time against U reshaped to a matrix."""
    N, k, d = A.shape
    a = A.reshape(N * k, d)
    out = []
    for L in cfg.hidden_ls:
        acc = 0
        for (LL, nu, P) in cfg.symcon_terms():
            if LL != L:
                continue
            U = _table("u", (tuple(cfg.a_ls), L, nu), A.device)
            W = weights[f"w_L{L}_nu{nu}"][species].reshape(N * k, P)
            if nu == 1:
                t = a @ U.reshape(d, -1)                               # [nk, M*P]
            elif nu == 2:
                t = (a @ U.reshape(d, -1)).reshape(N * k, d, -1)      # [nk, d, M*P]
                t = torch.einsum("nbq,nb->nq", t, a)
            else:
                aa = (a[:, :, None] * a[:, None, :]).reshape(N * k, d * d)
                t = (aa @ U.reshape(d * d, -1)).reshape(N * k, d, -1)  # [nk, d, M*P]
                t = torch.einsum("ncq,nc->nq", t, a)
            acc = acc + torch.einsum("nme,ne->nm", t.reshape(N * k, 2 * L + 1, P), W)
        out.append(acc.reshape(N, k, 2 * L + 1))
    return torch.cat(out, dim=-1)


def energy(params: Params, cfg: Config, g: Dict[str, torch.Tensor], n_graphs: int):
    """Energy of each graph [n_graphs] of an unpadded batch ``g``: species,
    positions, senders, receivers, graph_id."""
    species, pos = g["species"], g["positions"]
    snd, rcv = g["senders"], g["receivers"]
    N, k = species.shape[0], cfg.channels
    vec = pos[rcv] - pos[snd]
    lengths = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
    Y = spherical_harmonics(cfg.sh_lmax, vec)
    radial = radial_basis(lengths, cfg.r_max, cfg.num_bessel)
    h = params["embed"][species][:, :, None]
    site = pos.new_zeros((N,))
    hid = dict(_slices(cfg.hidden_ls))
    for t in range(cfg.n_interactions):
        lp = params[f"layer_{t}"]
        h_ls = cfg.h_ls(t)
        h_up = linear(lp["lin_up"], h, h_ls)
        R = mlp(lp["radial"], radial).reshape(-1, len(cfg.paths(t)), k)
        msgs = tensor_product(cfg, t, Y, h_up[snd], R)
        A = pos.new_zeros((N, k, msgs.shape[-1])).index_add(0, rcv, msgs)
        A = linear(lp["lin_a"], A / cfg.avg_num_neighbors, cfg.a_ls)
        B = symmetric_contraction(cfg, A, species, lp["symcon"])
        m = linear(lp["lin_msg"], B, cfg.hidden_ls)
        skip = []
        for l, sl in _slices(cfg.hidden_ls):
            src = dict((ll, (i, s)) for i, (ll, s) in enumerate(_slices(h_ls))).get(l)
            if src is None:
                skip.append(torch.zeros_like(m[:, :, hid[l]]))
            else:
                i, s = src
                W = lp["skip"][f"l{l}_{i}"][species]
                skip.append(torch.einsum("nkd,nkq->nqd", h[:, :, s], W))
        h = m + torch.cat(skip, dim=-1)
        inv = h[:, :, hid[0]][:, :, 0]
        if t < cfg.n_interactions - 1:
            site = site + (inv @ lp["readout"])[:, 0]
        else:
            site = site + mlp(lp["readout_mlp"], inv)[:, 0]
    site = site + params["e0"][species]
    return pos.new_zeros((n_graphs,)).index_add(0, g["graph_id"], site)


def energy_forces(params: Params, cfg: Config, g, n_graphs: int, create_graph: bool):
    pos = g["positions"].detach().requires_grad_(True)
    e = energy(params, cfg, dict(g, positions=pos), n_graphs)
    (grad,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph)
    return e, -grad


# ----------------------------- batches -------------------------------------


def batch_of(mols, device) -> Dict[str, torch.Tensor]:
    """Concatenate unpadded graphs: the real atoms and edges only."""
    off = np.cumsum([0] + [m.n_atoms for m in mols])
    cat = np.concatenate
    arrays = {
        "species": cat([m.species for m in mols]).astype(np.int64),
        "positions": cat([m.positions for m in mols]).astype(np.float32),
        "senders": cat([m.senders.astype(np.int64) + o for m, o in zip(mols, off)]),
        "receivers": cat([m.receivers.astype(np.int64) + o for m, o in zip(mols, off)]),
        "graph_id": np.repeat(np.arange(len(mols)), [m.n_atoms for m in mols]),
        "energy": np.asarray([m.energy for m in mols], np.float32),
        "forces": cat([m.forces for m in mols]).astype(np.float32),
        "n_atoms": np.asarray([m.n_atoms for m in mols], np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def blocks_of(mols, max_atoms: int) -> List[list]:
    """Consecutive groups of whole graphs of at most ``max_atoms`` atoms
    (a larger graph alone)."""
    out, cur, n = [], [], 0
    for m in mols:
        if cur and n + m.n_atoms > max_atoms:
            out.append(cur)
            cur, n = [], 0
        cur.append(m)
        n += m.n_atoms
    if cur:
        out.append(cur)
    return out
