"""Port parity, the multi-device placements: every rule of
``repro_torch.launch.sharding`` against the JAX package's
``launch/sharding.py`` on both production meshes, for all ten
architectures' full configs and the MACE model.

The JAX side runs once, in a subprocess with 512 forced host devices (as
the JAX dry run does), and writes every leaf's ``PartitionSpec``,
``shard_shape`` and global shape.  The port side builds the same trees on
the meta device (nothing allocated) and places them on a ``DeviceMesh``
over a fake process group of 256 or 512 ranks.  A port leaf is one layer
where the JAX leaf stacks a segment's repeats, so each port leaf is held
to the JAX leaf's spec and shard shape without their leading entry: its
placements equal ``to_placements`` of that spec, and its local shard shape
(DTensor's own, from ``distribute_tensor``) equals that shard shape.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro.launch import shapes as jshapes
from repro.configs import get_config as jget_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.mace_cfm import CONFIG as MACE_CONFIG
from repro_torch.core.mace import init_mace
from repro_torch.launch import shapes, sharding
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": 256, "multi": 512}
TRAIN_MODES = ("tp_fsdp", "fsdp", "replicate")
STATE_SHAPES = {128: 32768, 1: 524288}   # decode_32k and long_500k: B -> S
MACE_BINS = 32

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from repro.configs import ARCH_IDS, get_config
from repro.configs.mace_cfm import CONFIG as MCFG
from repro.core.mace import init_mace
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import LM_SHAPES, lm_batch_specs, lm_decode_state_specs, lm_param_specs
from repro.launch import sharding as sh

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

def table(specs, shardings):
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(specs)[0]
    shards = jax.tree_util.tree_leaves(shardings)
    for (path, leaf), s in zip(leaves, shards):
        spec = [list(e) if isinstance(e, tuple) else e for e in s.spec]
        spec += [None] * (len(leaf.shape) - len(spec))
        out[key(path)] = [spec, list(s.shard_shape(leaf.shape)), list(leaf.shape)]
    return out

res = {}
for mesh_name in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    r = res[mesh_name] = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        p = lm_param_specs(cfg)
        a = r[arch] = {}
        for mode in ("tp_fsdp", "fsdp", "replicate"):
            a["train_" + mode] = table(p, sh.lm_param_shardings(mesh, p, mode=mode))
        for tp in (True, False):
            a["inference_%s" % tp] = table(p, sh.lm_param_shardings_inference(mesh, p, tp=tp))
        b = lm_batch_specs(cfg, LM_SHAPES["train_4k"])
        a["batch"] = table(b, sh.lm_batch_shardings(mesh, b))
        for B, S in ((128, 32768), (1, 524288)):
            s = lm_decode_state_specs(cfg, B, S)
            a["state_%d" % B] = table(s, sh.lm_state_shardings(mesh, s, B))
    mp = jax.eval_shape(lambda k: init_mace(k, MCFG), jax.random.PRNGKey(0))
    for ctp in (False, True):
        r["mace_%s" % ctp] = table(mp, sh.mace_param_shardings(mesh, mp, channel_tp=ctp))
    mb = {"species": jax.ShapeDtypeStruct((N_BINS, 3072), jnp.int32),
          "positions": jax.ShapeDtypeStruct((N_BINS, 3072, 3), jnp.float32)}
    r["mace_batch"] = table(mb, sh.mace_batch_shardings(mesh, mb))
json.dump(res, open(sys.argv[1], "w"))
""".replace("N_BINS", str(MACE_BINS))


@pytest.fixture(scope="module")
def jax_rules(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "rules.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module", autouse=True)
def _teardown_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(name):
    fake_world(MESHES[name])
    return make_production_mesh(multi_pod=name == "multi", device_type="cpu")


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _jax_key_of_layer(cfg):
    """Port layer index -> the JAX ``seg{si}/{pos}`` prefix of its stack."""
    out, layer = {}, 0
    for si, (plen, reps) in enumerate(cfg.segments):
        for _ in range(reps):
            for pos in range(plen):
                out[layer] = f"seg{si}/{pos}"
                layer += 1
    return out


def _param_key(cfg, name):
    if not name.startswith("layers."):
        return name, False
    _, i, rest = name.split(".", 2)
    return f"{_jax_key_of_layer(cfg)[int(i)]}/{rest.replace('.', '/')}", True


def _hold(mesh, tensor, placements, want, stacked, what):
    """One port leaf against its JAX row ``[spec, shard_shape, shape]``."""
    spec, shard_shape, shape = want
    if stacked:
        spec, shard_shape, shape = spec[1:], shard_shape[1:], shape[1:]
    assert tuple(tensor.shape) == tuple(shape), what
    assert tuple(placements) == sharding.to_placements(mesh, _spec(spec)), (what, spec)
    local = distribute_tensor(torch.empty(tensor.shape, device="meta"), mesh, placements,
                              src_data_rank=None).to_local().shape
    assert tuple(local) == tuple(shard_shape), (what, spec)
    assert sharding.local_shape(mesh, tensor.shape, placements) == tuple(shard_shape), what


@pytest.mark.slow  # a subprocess device mesh
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_placements_match_jax(jax_rules, mesh_name, arch):
    """Training (``tp_fsdp``, ``fsdp``, ``replicate``) and inference (TP on
    and off) placements of every parameter of the full config."""
    mesh = _mesh(mesh_name)
    cfg = get_config(arch)
    params = shapes.lm_param_specs(cfg)
    rules = jax_rules[mesh_name][arch]
    tables = {f"train_{m}": sharding.lm_param_shardings(mesh, params, mode=m) for m in TRAIN_MODES}
    for tp in (True, False):
        tables[f"inference_{tp}"] = sharding.lm_param_shardings_inference(mesh, params, tp=tp)
    named = dict(params.named_parameters())
    for rule, placed in tables.items():
        assert len(placed) == len(named)
        seen = set()
        for name, pl in placed.items():
            key, stacked = _param_key(cfg, name)
            seen.add(key)
            _hold(mesh, named[name], pl, rules[rule][key], stacked, (rule, name))
        assert seen == set(rules[rule]), rule


@pytest.mark.slow  # a subprocess device mesh
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_decode_state_placements_match_jax(jax_rules, mesh_name, arch):
    """``lm_batch_shardings`` on the ``train_4k`` batch, and
    ``lm_state_shardings`` on the decode state at B = 128 (``decode_32k``)
    and B = 1 (``long_500k``, the sequence over every axis)."""
    mesh = _mesh(mesh_name)
    cfg = get_config(arch)
    rules = jax_rules[mesh_name][arch]
    batch = shapes.lm_batch_specs(cfg, shapes.LM_SHAPES["train_4k"])
    for name, pl in sharding.lm_batch_shardings(mesh, batch).items():
        _hold(mesh, batch[name], pl, rules["batch"][name], False, name)
    prefix = _jax_key_of_layer(cfg)
    for B, S in STATE_SHAPES.items():
        state = shapes.lm_decode_state_specs(cfg, B, S)
        placed = sharding.lm_state_shardings(mesh, state, B)
        seen = set()
        for i, (layer, pls) in enumerate(zip(state, placed)):
            for name, pl in pls.items():
                key = f"{prefix[i]}/{name}"
                seen.add(key)
                _hold(mesh, layer[name], pl, rules[f"state_{B}"][key], True, (B, i, name))
        assert seen == set(rules[f"state_{B}"])


@pytest.mark.slow  # a subprocess device mesh
@pytest.mark.parametrize("channel_tp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mace_placements_match_jax(jax_rules, mesh_name, channel_tp):
    """``mace_param_shardings`` (pure DDP, and ``channel_tp`` over 'model')
    on the paper's config, and ``mace_batch_shardings`` on 32 bins."""
    from repro_torch.bridge import flatten

    mesh = _mesh(mesh_name)
    params = init_mace(MACE_CONFIG, torch.Generator().manual_seed(0))
    rules = jax_rules[mesh_name][f"mace_{channel_tp}"]
    flat_params = flatten(params)
    flat_placed = flatten(sharding.mace_param_shardings(mesh, params, channel_tp=channel_tp))
    assert set(flat_placed) == set(rules)
    for key, pl in flat_placed.items():
        _hold(mesh, flat_params[key], pl, rules[key], False, key)
    batch = {"species": torch.empty((MACE_BINS, 3072), dtype=torch.int32, device="meta"),
             "positions": torch.empty((MACE_BINS, 3072, 3), device="meta")}
    for key, pl in sharding.mace_batch_shardings(mesh, batch).items():
        _hold(mesh, batch[key], pl, jax_rules[mesh_name]["mace_batch"][key], False, key)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_jax_shapes_unstacked(arch):
    """``lm_param_specs``: every meta parameter has the shape and dtype of
    its JAX ``eval_shape`` leaf without the stack axis, and nothing is
    allocated."""
    import jax
    import numpy as np
    from repro.models.model import init_params as jinit

    cfg, jcfg = get_config(arch), jget_config(arch)
    params = shapes.lm_param_specs(cfg)
    jtree = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    seen = set()
    for name, p in params.named_parameters():
        assert p.is_meta, name
        key, stacked = _param_key(cfg, name)
        seen.add(key)
        want = flat[key].shape[1:] if stacked else flat[key].shape
        assert tuple(p.shape) == tuple(want), name
        assert str(p.dtype).split(".")[-1] == np.dtype(flat[key].dtype).name, name
    assert seen == set(flat)


def test_shape_sets_and_skip_reasons_are_the_jax_ones():
    assert shapes.LM_SHAPES == jshapes.LM_SHAPES
    assert shapes.MACE_SHAPES == jshapes.MACE_SHAPES
    for arch in ARCH_IDS:
        for shape in shapes.LM_SHAPES:
            assert shapes.shape_skip_reason(get_config(arch), shape) == \
                jshapes.shape_skip_reason(jget_config(arch), shape), (arch, shape)


def test_checked_drops_axes_that_do_not_divide_and_placements_keep_mesh_order():
    """The JAX ``_checked`` on the multi-pod mesh, case by case: an axis is
    kept only where the product so far divides the dim (``pod`` alone for
    a dim of 2), and a dim split over (pod, data) is ``Shard`` on both
    mesh dims in mesh order; out-of-order axes are refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh("multi")
    assert sharding._checked(mesh, (64, 7), (("pod", "data"), "model")) == (("pod", "data"), None)
    assert sharding._checked(mesh, (2, 32), (("pod", "data"), "model")) == ("pod", "model")
    assert sharding._checked(mesh, (16, 5), (("pod", "data"), None)) == ("pod", None)
    assert sharding.to_placements(mesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.to_placements(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(mesh, (("data", "pod"), None))
