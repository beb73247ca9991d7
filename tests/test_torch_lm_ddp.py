"""Port parity, the LM scaffold's multi-device steps, on gloo CPU processes:

* ``make_lm_train_step_ddp`` on 2 processes against the JAX
  ``make_lm_train_step_ddp`` on a 2-device mesh (a subprocess with forced
  host devices), REDUCED xlstm, 4 x 16 packed tokens from a numpy seed,
  the JAX weights on both sides (``bridge.lm_params_from_jax``): two plain
  steps and one compressed;
* the sharded ``make_lm_train_step`` (DTensor parameters placed by
  ``lm_param_shardings``, ``tp_fsdp``) on 4 processes, a ``(2, 2)`` mesh,
  against the one-process step, REDUCED granite and REDUCED qwen3-moe;
* the sharding hooks on plain tensors: nothing changes, bit for bit.

Bounds (tests/test_backward.py's 2e-4; losses 2e-5): losses everywhere;
``m``, ``v`` and the parameters where Adam is well conditioned (its
sqrt(v_hat) 0 or above 100 eps: near eps Adam turns float32 rounding into
up to lr of an update, tests/test_torch_train.py); the compressed step
only where both sides quantised an element to the same integer, the rest
counted and printed.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_reduced
from repro_torch.data.sequence_pack import pack_documents
from repro_torch.launch import lm_pretrain
from repro_torch.launch.lm_train_step import (
    init_opt_state,
    lm_value_and_grad,
    make_lm_train_step,
    rank_rows,
    stacked_groups,
)
from repro_torch.launch.multihost import spawn_local
from repro_torch.models import model as tm
from repro_torch.models import moe, xlstm

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
ADAM_EPS, ADAM_B2, ADAM_HELD_EPS = 1e-8, 0.999, 100
LR = 1e-3
DDP_ARCH, R = "xlstm_125m", 2
PLAIN_STEPS = 2
SPAWN_TIMEOUT_S = 300


def _packed_batch(cfg, B, S, seed=0):
    """B bins of S tokens: documents of 3 to min(19, S - 1) tokens packed by
    Algorithm 1, labels within each document."""
    rng = np.random.default_rng(seed)
    packed = pack_documents(rng.integers(3, min(20, S), size=60), S, B,
                            lambda d, ln: np.random.default_rng(d).integers(1, cfg.vocab, size=ln))
    return {k: v.numpy() for k, v in lm_pretrain.packed_batch(packed, 0, B, cfg, "cpu").items()}


def _held(v, step):
    den = np.sqrt(v / (1 - ADAM_B2 ** step))
    return (den == 0) | (den > ADAM_HELD_EPS * ADAM_EPS)


# --------------------------- DDP against JAX ---------------------------------

JAX_DDP = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_reduced
from repro.launch.lm_train_step import make_lm_train_step_ddp
from repro.models import model as jm
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import get_reduced as tget
from repro_torch.models.model import LM

arch, out, lr, plain_steps = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
jc, tc = get_reduced(arch), tget(arch)
batch = dict(np.load(os.path.join(out, "batch.npz")))

def named(tree):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return {n: p.detach().numpy() for n, p in LM(tc, lm_params_from_jax(tree, tc)).named_parameters()}

p0 = jm.init_params(jax.random.PRNGKey(0), jc)
np.savez(os.path.join(out, "init.npz"), **named(p0))
mesh = jax.make_mesh((2,), ("data",))
zeros = lambda: jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), p0)
losses = {}
for compress, steps in ((False, plain_steps), (True, 1)):
    step = jax.jit(make_lm_train_step_ddp(jc, mesh, lr=lr, compress=compress))
    p, m, v = p0, zeros(), zeros()
    ls = []
    for i in range(steps):
        p, m, v, loss = step(p, m, v, batch, jnp.asarray(i))
        ls.append(float(loss))
    losses[str(compress)] = ls
    for tag, tree in (("p", p), ("m", m), ("v", v)):
        np.savez(os.path.join(out, f"jax_{compress}_{tag}.npz"), **named(tree))
# each rank's gradient of the first step, for the quantised integers
B = batch["tokens"].shape[0]
for r in range(2):
    rows = {k: a[r * B // 2:(r + 1) * B // 2] for k, a in batch.items()}
    g = jax.grad(lambda q: jm.forward_train(q, jc, rows)[0])(p0)
    np.savez(os.path.join(out, f"jax_grad{r}.npz"), **named(g))
json.dump(losses, open(os.path.join(out, "jax_losses.json"), "w"))
"""

PORT_DDP = r"""
import os, sys, json
import numpy as np, torch
from repro_torch.configs import get_reduced
from repro_torch.launch.lm_train_step import init_opt_state, make_lm_train_step_ddp
from repro_torch.launch.multihost import initialize_distributed
from repro_torch.models.model import init_params
import torch.distributed as dist

arch, out, lr, plain_steps = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
initialize_distributed(backend="gloo", timeout_s=120)
rank = dist.get_rank()
cfg = get_reduced(arch)
init = np.load(os.path.join(out, "init.npz"))
batch = {k: torch.from_numpy(a) for k, a in np.load(os.path.join(out, "batch.npz")).items()}
losses = {}
for compress, steps in ((False, plain_steps), (True, 1)):
    model = init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[n]))
    m, v = init_opt_state(model)
    step = make_lm_train_step_ddp(cfg, lr=lr, compress=compress)
    ls = []
    for i in range(steps):
        model, m, v, loss, gnorm = step(model, m, v, batch, i)
        ls.append(float(loss))
    losses[str(compress)] = ls
    np.savez(os.path.join(out, f"port_{compress}_{rank}.npz"),
             **{f"p/{n}": p.detach().numpy() for n, p in model.named_parameters()},
             **{f"m/{n}": t.numpy() for n, t in m.items()},
             **{f"v/{n}": t.numpy() for n, t in v.items()})
json.dump(losses, open(os.path.join(out, f"port_losses_{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _spawn(n, code, args, tmp):
    res = spawn_local(n, [sys.executable, "-c", code, *map(str, args)], env=ENV,
                      log_dir=str(tmp / "logs"))
    codes = res.wait(timeout=SPAWN_TIMEOUT_S)
    logs = "".join(Path(p.log_path).read_text()[-3000:] for p in res.procs)
    assert codes == [0] * n, logs


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    """Both sides' runs: the JAX subprocess, then the 2 port processes."""
    tmp = tmp_path_factory.mktemp("ddp")
    cfg = get_reduced(DDP_ARCH)
    np.savez(tmp / "batch.npz", **_packed_batch(cfg, 4, 16))
    proc = subprocess.run([sys.executable, "-c", JAX_DDP, DDP_ARCH, str(tmp), str(LR),
                           str(PLAIN_STEPS)], env=ENV, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _spawn(R, PORT_DDP, [DDP_ARCH, tmp, LR, PLAIN_STEPS], tmp)
    return tmp


def _port(tmp, compress, rank):
    return dict(np.load(tmp / f"port_{compress}_{rank}.npz"))


def _jax(tmp, compress, tag):
    return dict(np.load(tmp / f"jax_{compress}_{tag}.npz"))


@pytest.mark.slow  # a subprocess device mesh
@pytest.mark.parametrize("compress", [False, True])
def test_ddp_ranks_stay_bit_identical_replicas(ddp_runs, compress):
    a, b = _port(ddp_runs, compress, 0), _port(ddp_runs, compress, 1)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    la = json.loads((ddp_runs / "port_losses_0.json").read_text())
    lb = json.loads((ddp_runs / "port_losses_1.json").read_text())
    assert la == lb


@pytest.mark.slow  # a subprocess device mesh
def test_plain_ddp_matches_jax(ddp_runs):
    """Two plain steps: losses within 2e-5; m and v everywhere and the
    parameters where Adam is well conditioned within 2e-4."""
    port = _port(ddp_runs, False, 0)
    jl = json.loads((ddp_runs / "jax_losses.json").read_text())["False"]
    pl = json.loads((ddp_runs / "port_losses_0.json").read_text())["False"]
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    jp, jmo, jv = (_jax(ddp_runs, False, t) for t in "pmv")
    n_held = n_all = 0
    for n in jp:
        np.testing.assert_allclose(port[f"m/{n}"], jmo[n], err_msg=n, **GRAD_TOL)
        np.testing.assert_allclose(port[f"v/{n}"], jv[n], err_msg=n, **GRAD_TOL)
        h = _held(jv[n], PLAIN_STEPS)
        np.testing.assert_allclose(port[f"p/{n}"][h], jp[n][h], err_msg=n, **GRAD_TOL)
        assert np.abs(port[f"p/{n}"] - jp[n]).max() <= PLAIN_STEPS * LR + 2e-4, n
        n_held, n_all = n_held + int(h.sum()), n_all + h.size
    assert n_all - n_held < 0.01 * n_all, (n_held, n_all)


@pytest.mark.slow  # a subprocess device mesh
def test_compressed_ddp_matches_jax_where_both_quantised_alike(ddp_runs):
    """One compressed step.  Each side's integers are recomputed from its
    own per-rank gradients (the port's in this process, the JAX ones from
    the JAX run) with one scale per stacked JAX leaf
    (``stacked_groups``); wherever both ranks' integers agree on both
    sides, m, v and the parameters (Adam well conditioned) are held at
    2e-4.  A recomputed gradient can differ from the run's in its last bit,
    so an element within 1e-3 of a rounding tie on either side counts as
    not alike (which way the run rounded it is unknown).  The loss (a plain
    mean) everywhere."""
    torch.set_num_threads(1)  # as the rank processes
    cfg = get_reduced(DDP_ARCH)
    jl = json.loads((ddp_runs / "jax_losses.json").read_text())["True"]
    pl = json.loads((ddp_runs / "port_losses_0.json").read_text())["True"]
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    init = dict(np.load(ddp_runs / "init.npz"))
    batch = {k: torch.from_numpy(a) for k, a in np.load(ddp_runs / "batch.npz").items()}
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[n]))
    port_g = [lm_value_and_grad(model, cfg, rank_rows(batch, r, R))[1] for r in range(R)]
    jax_g = [dict(np.load(ddp_runs / f"jax_grad{r}.npz")) for r in range(R)]

    def integers(grads):
        """{name: ([R, ...] integers, [R, ...] near a tie)}."""
        out = {}
        for group in stacked_groups(cfg, list(grads[0])):
            g = np.stack([np.stack([np.asarray(gr[n], np.float32) for n in group])
                          for gr in grads])                     # [R, reps, ...]
            scale = np.float32(np.abs(g).max() / np.float32(127.0) + np.float32(1e-12))
            x = g / scale
            q = np.clip(np.round(x), -127, 127)
            tie = np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3
            for i, n in enumerate(group):
                out[n] = (q[:, i], tie[:, i])
        return out

    qp = integers([{n: g.numpy() for n, g in pg.items()} for pg in port_g])
    qj = integers(jax_g)
    port = _port(ddp_runs, True, 0)
    jp, jmo, jv = (_jax(ddp_runs, True, t) for t in "pmv")
    alike = total = 0
    for n in jp:
        same = np.all((qp[n][0] == qj[n][0]) & ~qp[n][1] & ~qj[n][1], axis=0)
        alike, total = alike + int(same.sum()), total + same.size
        np.testing.assert_allclose(port[f"m/{n}"][same], jmo[n][same], err_msg=n, **GRAD_TOL)
        np.testing.assert_allclose(port[f"v/{n}"][same], jv[n][same], err_msg=n, **GRAD_TOL)
        h = same & _held(jv[n], 1)
        np.testing.assert_allclose(port[f"p/{n}"][h], jp[n][h], err_msg=n, **GRAD_TOL)
    print(f"compressed DDP: {alike} of {total} elements quantised alike on both sides, "
          f"{total - alike} counted, not held")
    assert alike > 0.99 * total, (alike, total)


# --------------------------- sharded step ------------------------------------

PORT_SHARDED = r"""
import os, sys, json
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_reduced
from repro_torch.launch.lm_train_step import init_opt_state, make_lm_train_step
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.multihost import initialize_distributed
from repro_torch.launch.sharding import (distribute_params, lm_batch_shardings,
                                         lm_param_shardings, to_placements)
from repro_torch.models import model as tm

arch, out, lr, steps = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
initialize_distributed(backend="gloo", timeout_s=120)
cfg = get_reduced(arch)
mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
model = tm.init_params(cfg, torch.Generator().manual_seed(0))
distribute_params(model, mesh, lm_param_shardings(mesh, model, mode="tp_fsdp"))
m, v = init_opt_state(model)
batch = {k: torch.from_numpy(a) for k, a in np.load(os.path.join(out, "batch.npz")).items()}
batch = distribute_params(batch, mesh, lm_batch_shardings(mesh, batch))
tm.set_activation_sharding(to_placements(mesh, ("data", None, None)))
step = make_lm_train_step(cfg, lr=lr)
losses = []
for i in range(steps):
    model, m, v, loss, gnorm = step(model, m, v, batch, i)
    losses.append(float(loss.full_tensor()))
full = {f"p/{n}": p.full_tensor().detach().numpy() for n, p in model.named_parameters()}
full.update({f"m/{n}": t.full_tensor().numpy() for n, t in m.items()})
full.update({f"v/{n}": t.full_tensor().numpy() for n, t in v.items()})
if dist.get_rank() == 0:
    np.savez(os.path.join(out, "sharded.npz"), **full)
    json.dump(losses, open(os.path.join(out, "losses.json"), "w"))
dist.destroy_process_group()
"""


@pytest.mark.slow  # a subprocess device mesh
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_sharded_step_on_a_2x2_mesh_matches_one_process(tmp_path, arch):
    """Two ``tp_fsdp`` steps on 4 gloo processes (a ``(2, 2)`` ``("data",
    "model")`` mesh, the batch over ``data``, the residual stream pinned to
    pure-DP placements) against the same two steps in this process:
    losses within 2e-5, the ``full_tensor()`` of m and v within 2e-4 and of
    the parameters where Adam is well conditioned."""
    steps = 2
    cfg = get_reduced(arch)
    batch = _packed_batch(cfg, 4, 32)
    np.savez(tmp_path / "batch.npz", **batch)
    _spawn(4, PORT_SHARDED, [arch, tmp_path, LR, steps], tmp_path)
    got = dict(np.load(tmp_path / "sharded.npz"))
    losses = json.loads((tmp_path / "losses.json").read_text())

    torch.set_num_threads(1)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    m, v = init_opt_state(model)
    step = make_lm_train_step(cfg, lr=LR)
    want = []
    for i in range(steps):
        model, m, v, loss, _ = step(model, m, v, {k: torch.from_numpy(a) for k, a in batch.items()}, i)
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, **LOSS_TOL)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(got[f"m/{n}"], m[n].numpy(), err_msg=n, **GRAD_TOL)
        np.testing.assert_allclose(got[f"v/{n}"], v[n].numpy(), err_msg=n, **GRAD_TOL)
        h = _held(v[n].numpy(), steps)
        np.testing.assert_allclose(got[f"p/{n}"][h], p.detach().numpy()[h], err_msg=n, **GRAD_TOL)
        assert np.abs(got[f"p/{n}"] - p.detach().numpy()).max() <= steps * LR + 2e-4, n


# --------------------------- hooks on plain tensors --------------------------


def test_sharding_hooks_change_nothing_on_plain_tensors():
    """With the activation and expert-parallel hooks set, a plain-tensor
    forward, backward, prefill and decode step of REDUCED qwen3-moe (MoE
    and attention) equal the unhooked ones bit for bit."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_reduced("qwen3_moe_235b_a22b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(a) for k, a in _packed_batch(cfg, 2, 32).items()}

    def run():
        loss, grads = lm_value_and_grad(model, cfg, batch)
        with torch.no_grad():
            logits, state = tm.forward_prefill(model, cfg, batch["tokens"])
            dec, _ = tm.decode_step(model, tm.init_decode_state(cfg, 2, 40), cfg,
                                    batch["tokens"][:, :1], 3)
        return [loss, logits, dec] + [grads[n] for n in sorted(grads)]

    plain = run()
    try:
        tm.set_activation_sharding((Shard(0), Replicate()))
        moe.set_ep_sharding((Replicate(), Shard(0)), (Replicate(), Shard(0)))
        hooked = run()
    finally:
        tm.set_activation_sharding(None)
        moe.set_ep_sharding(None)
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)


def test_mlstm_gate_on_a_dtensor_is_logsigmoid_within_an_ulp():
    """``F.logsigmoid``'s backward has no DTensor strategy; on a DTensor the
    mLSTM forget gate is the same function from pointwise ops.  On a
    1-device mesh (real values), it and its gradient are within an ulp of
    ``F.logsigmoid``'s, and a plain tensor still takes ``F.logsigmoid``
    itself."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    z = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 8
    assert torch.equal(xlstm._log_sigmoid(z), F.logsigmoid(z))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        zd = distribute_tensor(z.clone().requires_grad_(True), mesh, [Replicate()])
        out = xlstm._log_sigmoid(zd)
        (g,) = torch.autograd.grad(out.sum(), zd)
        zz = z.clone().requires_grad_(True)
        want = F.logsigmoid(zz)
        (gw,) = torch.autograd.grad(want.sum(), zz)
        torch.testing.assert_close(out.full_tensor(), want.detach(), rtol=0, atol=1e-6)
        torch.testing.assert_close(g.full_tensor(), gw, rtol=0, atol=2e-7)
    finally:
        dist.destroy_process_group()


def test_xlstm_at_bf16_compute_runs_within_the_bf16_bound_of_jax():
    """REDUCED xlstm with bf16 compute (the published config's): the
    mLSTM's float32 stabiliser terms meet bf16 q, k, v in its einsums,
    which ``jnp.einsum`` promotes and ``torch.einsum`` refused ("expected
    scalar type Float but found BFloat16").  The loss and one decode step's
    logits within the bf16 bound (``PRECISION_TOL["bf16"]`` = 5e-2,
    relative) of the JAX model's on the same weights and tokens."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget
    from repro.models import model as jm
    from repro_torch.bridge import lm_params_from_jax

    jc = dataclasses.replace(jget("xlstm_125m"), compute_dtype=jnp.bfloat16)
    tc = dataclasses.replace(get_reduced("xlstm_125m"), compute_dtype=torch.bfloat16)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    model = tm.LM(tc, lm_params_from_jax(jax.tree.map(np.asarray, jp), tc))
    tok = np.random.default_rng(0).integers(1, tc.vocab, size=(2, 32)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    want = float(jm.forward_train(jp, jc, {"tokens": tok, "labels": lab})[0])
    loss, grads = lm_value_and_grad(model, tc, {"tokens": torch.from_numpy(tok),
                                                "labels": torch.from_numpy(lab)})
    np.testing.assert_allclose(float(loss), want, rtol=5e-2)
    assert all(torch.isfinite(g).all() for g in grads.values())
    with torch.no_grad():
        got, _ = tm.decode_step(model, tm.init_decode_state(tc, 2, 8), tc,
                                torch.from_numpy(tok[:, :1]), 0)
    jlog, _ = jm.decode_step(jp, jm.init_decode_state(jc, 2, 8), jc, tok[:, :1], 0)
    jlog = np.asarray(jlog, np.float32)
    err = np.linalg.norm(got.float().numpy() - jlog) / np.linalg.norm(jlog)
    assert err < 5e-2, err


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_xlstm_train_logits_per_mlstm_chunk_within_the_bf16_bound_of_jax(dtype):
    """The training forward's logits at every position (embedding, the
    layers as ``forward_train`` runs them, final norm, head) of REDUCED
    xlstm against the JAX model's on the same weights and tokens, at fp32
    and at bf16 compute: over each 256-position mLSTM chunk, the
    norm-relative error within the bf16 bound (``PRECISION_TOL["bf16"]``
    = 5e-2).  S = 512 gives two chunks, so the second reads the carry
    through the widened q (``_mlstm_chunk``'s float32 operands); the loss
    alone, near ln V at random weights, would not see a wrong widening."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget
    from repro.models import model as jm
    from repro.models.layers import rms_norm as jrms
    from repro_torch.bridge import lm_params_from_jax
    from repro_torch.models.layers import rms_norm

    jd, td = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jc = dataclasses.replace(jget("xlstm_125m"), compute_dtype=jd)
    tc = dataclasses.replace(get_reduced("xlstm_125m"), compute_dtype=td)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    model = tm.LM(tc, lm_params_from_jax(jax.tree.map(np.asarray, jp), tc))
    B, S, chunk = 1, 512, 256
    tok = np.random.default_rng(0).integers(1, tc.vocab, size=(B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    x, _ = jm._run_segments(jc, jp, jm._embed(jc, jp, tok, None), pos, None, train=True)
    want = np.asarray((jrms(x, jp["final_norm"], jc.norm_eps) @ jp["head"].astype(jd))
                      .astype(jnp.float32))
    with torch.no_grad():
        y, _ = tm._run_segments(tc, model, tm._embed(tc, model, torch.from_numpy(tok), None),
                                torch.from_numpy(pos.copy()), None, train=True)
        got = (rms_norm(y, model.final_norm, tc.norm_eps) @ model.head.to(td)).float().numpy()
    errs = [np.linalg.norm(got[:, c:c + chunk] - want[:, c:c + chunk])
            / np.linalg.norm(want[:, c:c + chunk]) for c in range(0, S, chunk)]
    print(f"xlstm {dtype} training logits, norm-relative error per mLSTM chunk: {[float(e) for e in errs]}")
    assert max(errs) < 5e-2, errs
