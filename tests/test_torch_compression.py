"""Port parity, the int8 error-feedback all-reduce on ``torch.distributed``.

One group of 17 gloo processes (``launch.multihost.spawn_local``) runs the
port's ``compressed_allreduce_ef`` over sub-groups of 1, 2, 3, 16 and 17
ranks (17 is past the float16 wire's 16, so the int32 wire) and over the
2 x 2 hierarchical pattern, on numpy inputs made from one seed, and writes
each rank's results; the tests hold them bit for bit to the JAX package's
host emulations ``_emulated_compressed_mean_ef`` and
``_emulated_hier_compressed_mean``, which the JAX engine tests hold to its
collective.  The same group checks the wire itself: the float16 sum is
exact at +-127 x 16, and an int8 sum wraps (why int8 is not the wire).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.train import compression as jcomp
from repro.train.engine import _emulated_compressed_mean_ef as j_flat
from repro.train.engine import _emulated_hier_compressed_mean as j_hier
from repro_torch.launch.multihost import spawn_local
from repro_torch.train import compression as comp
from repro_torch.train.engine import _emulated_compressed_mean_ef as t_flat
from repro_torch.train.engine import _emulated_hier_compressed_mean as t_hier

REPO = Path(__file__).resolve().parents[1]
WORLD = 17
GROUPS = (1, 2, 3, 17)
SHAPES = [(37,), (5, 3), (7,)]
DEADLINE_S = 180

# Tensor 2 holds exact ties: its largest magnitude is 127 on every rank, so
# the scale is 127 / 127 + 1e-12 == 1.0 in float32 and c / scale = c.
TIES = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)


def _inputs():
    """Every rank's gradients and residuals, ``[WORLD, *shape]`` each."""
    rng = np.random.default_rng(0)
    g = [rng.normal(size=(WORLD,) + s).astype(np.float32) for s in SHAPES[:2]]
    e = [rng.normal(scale=1e-3, size=(WORLD,) + s).astype(np.float32) for s in SHAPES[:2]]
    g.append(np.broadcast_to(TIES, (WORLD, TIES.size)).copy())
    e.append(np.zeros((WORLD, TIES.size), np.float32))
    return g, e


CHILD = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.multihost import initialize_distributed
from repro_torch.train.compression import all_reduce_, compressed_allreduce_ef

out = sys.argv[1]
initialize_distributed(backend="gloo", timeout_s=60)
rank = dist.get_rank()
# every rank creates every group, in one order
groups = {n: dist.new_group(list(range(n))) for n in (1, 2, 3, 16)}
groups[17] = dist.group.WORLD
node_groups = [dist.new_group(r) for r in ([0, 1], [2, 3])]   # device hop
cross_groups = [dist.new_group(r) for r in ([0, 2], [1, 3])]  # node hop
inputs = np.load(f"{out}/inputs.npz")
g = [inputs[f"g{i}"] for i in range(3)]
e = [inputs[f"e{i}"] for i in range(3)]
res = {}
for n in (1, 2, 3, 17):
    if rank < n:
        gh, en = compressed_allreduce_ef([torch.from_numpy(x[rank]) for x in g],
                                         [torch.from_numpy(x[rank]) for x in e], groups[n])
        res.update({f"flat{n}_g{i}": t.numpy() for i, t in enumerate(gh)})
        res.update({f"flat{n}_e{i}": t.numpy() for i, t in enumerate(en)})
if rank < 4:
    node, dev = divmod(rank, 2)
    mean = [all_reduce_(torch.from_numpy(x[rank].copy()), group=node_groups[node]) / 2
            for x in g]
    gh, en = compressed_allreduce_ef(mean, [torch.from_numpy(x[node]) for x in e],
                                     cross_groups[dev], group_size=2)
    res.update({f"hier_g{i}": t.numpy() for i, t in enumerate(gh)})
    res.update({f"hier_e{i}": t.numpy() for i, t in enumerate(en)})
if rank < 16:
    wire = torch.tensor([127.0, -127.0, 1.0], dtype=torch.float16)
    res["fp16_sum"] = all_reduce_(wire, group=groups[16]).numpy()
if rank < 2:
    res["int8_sum"] = all_reduce_(torch.tensor([100], dtype=torch.int8), group=groups[2]).numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of the 17-process group."""
    out = tmp_path_factory.mktemp("compression")
    g, e = _inputs()
    np.savez(out / "inputs.npz", **{f"g{i}": x for i, x in enumerate(g)},
             **{f"e{i}": x for i, x in enumerate(e)})
    res = spawn_local(WORLD, [sys.executable, "-c", CHILD, str(out)],
                      env={"PYTHONPATH": str(REPO / "src")}, log_dir=str(out / "logs"))
    codes = res.wait(timeout=DEADLINE_S)
    logs = "".join(Path(p.log_path).read_text()[-2000:] for p in res.procs)
    assert codes == [0] * WORLD, logs
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _jax(fn, g, e, **kw):
    gh, en = fn(jnp.asarray(g), jnp.asarray(e), **kw)
    return np.asarray(gh), np.asarray(en)


@pytest.mark.parametrize("n", GROUPS)
def test_compressed_allreduce_is_the_jax_emulation_bit_for_bit(ranks, n):
    """Every rank of an n-rank group gets the JAX emulation's mean, and
    keeps its own row of the emulation's residuals, bit for bit (n = 1:
    the group of one is quantised, as the JAX collective without its size
    hint quantises it)."""
    g, e = _inputs()
    for i in range(len(SHAPES)):
        want_g, want_e = _jax(j_flat, g[i][:n], e[i][:n])
        for r in range(n):
            np.testing.assert_array_equal(ranks[r][f"flat{n}_g{i}"], want_g)
            np.testing.assert_array_equal(ranks[r][f"flat{n}_e{i}"], want_e[r])
    assert comp.wire_dtype(n) == (torch.float16 if n <= 16 else torch.int32)


def test_ties_round_half_to_even(ranks):
    """The tie tensor's quantised values are half-to-even (0.5 -> 0, 1.5 ->
    2, 2.5 -> 2), as ``jnp.round``: the mean of identical ranks is the
    rounded value itself."""
    np.testing.assert_array_equal(ranks[0]["flat3_g2"],
                                  np.array([127, 0, 2, 2, -0, -2, -2], np.float32))
    np.testing.assert_array_equal(ranks[0]["flat3_e2"],
                                  TIES - np.array([127, 0, 2, 2, 0, -2, -2], np.float32))


def test_hierarchical_pattern_is_the_jax_emulation_bit_for_bit(ranks):
    """2 nodes x 2 devices: the mean over each node's devices, then the
    compressed mean across nodes with per-node residuals, equal to
    ``_emulated_hier_compressed_mean``; both devices of a node hold the
    same residual."""
    g, e = _inputs()
    for i in range(len(SHAPES)):
        want_g, want_e = _jax(j_hier, g[i][:4], e[i][:2], n_nodes=2)
        for r in range(4):
            np.testing.assert_array_equal(ranks[r][f"hier_g{i}"], want_g)
            np.testing.assert_array_equal(ranks[r][f"hier_e{i}"], want_e[r // 2])


def test_wire_float16_is_exact_at_its_limit_and_int8_wraps(ranks):
    for r in range(16):
        np.testing.assert_array_equal(ranks[r]["fp16_sum"],
                                      np.array([2032, -2032, 16], np.float16))
    assert comp.MAX_FP16_GROUP * 127 == 2032 <= 2048
    # 100 + 100 on an int8 wire gives -56: an int8 sum wraps silently
    assert [int(ranks[r]["int8_sum"][0]) for r in range(2)] == [-56, -56]


@pytest.mark.parametrize("n", [1, 2, 3, 17])
def test_port_emulations_are_the_jax_ones(n):
    g, e = _inputs()
    for i in range(len(SHAPES)):
        want = _jax(j_flat, g[i][:n], e[i][:n])
        got = t_flat(torch.from_numpy(g[i][:n]), torch.from_numpy(e[i][:n]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        if n % 2 == 0 or n == 1:
            nodes = max(n // 2, 1)
            want = _jax(j_hier, g[i][:n], e[i][:nodes], n_nodes=nodes)
            got = t_hier(torch.from_numpy(g[i][:n]), torch.from_numpy(e[i][:nodes]),
                         n_nodes=nodes)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)


def test_group_size_one_is_the_exact_identity():
    """The single-node hop: no quantisation, the residual untouched (the
    JAX ``axis_size=1`` contract, tests/test_compression.py)."""
    g, e = torch.randn(37), torch.randn(37) * 1e-3
    got_g, got_e = comp.compressed_allreduce_ef(g, e, None, group_size=1)
    assert got_g is g and got_e is e
    want = _jax(j_hier, g.numpy()[None], e.numpy()[None], n_nodes=1)
    np.testing.assert_array_equal(want[0], g.numpy())
    np.testing.assert_array_equal(want[1], e.numpy()[None])


def test_int8_compress_decompress_and_chunking_match_jax():
    g = np.random.default_rng(1).normal(size=(41,)).astype(np.float32)
    got = comp.int8_compress_decompress(torch.from_numpy(g))
    want = jcomp.int8_compress_decompress(jnp.asarray(g))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert comp.MAX_INT16_GROUP == jcomp.MAX_INT16_GROUP
    for size in (1, 7, 258, 259, 516, 521, 1000):
        assert comp._chunk_size(size) == jcomp._chunk_size(size)
        assert comp._chunk_groups(size) == jcomp._chunk_groups(size)


def test_compressed_allreduce_refuses_a_wrong_size_hint_and_drops_no_residual(tmp_path):
    """In a world of one process: a size hint other than the group's is an
    error, and ``compressed_allreduce`` (no error feedback) is the JAX
    ``compressed_psum`` over a group of one."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from repro_torch.launch.multihost import initialize_distributed\n"
        "from repro_torch.train.compression import compressed_allreduce, compressed_allreduce_ef\n"
        f"initialize_distributed('file://{tmp_path}/store', 1, 0, backend='gloo')\n"
        "g = torch.tensor([3.0, -1.0, 0.7])\n"
        "try:\n"
        "    compressed_allreduce_ef(g, torch.zeros(3), group_size=2)\n"
        "    raise SystemExit('a wrong size hint was accepted')\n"
        "except ValueError:\n"
        "    pass\n"
        "print(compressed_allreduce(g).numpy().tobytes().hex())\n"
        "dist.destroy_process_group()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.frombuffer(bytes.fromhex(proc.stdout.split()[-1]), np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    psum = jax.shard_map(lambda x: jcomp.compressed_psum(x, "data"), mesh=mesh,
                     in_specs=P(), out_specs=P())
    np.testing.assert_array_equal(got, np.asarray(psum(jnp.asarray([3.0, -1.0, 0.7]))))
