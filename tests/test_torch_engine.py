"""Port parity, the engines: the sequential oracle against the JAX one, and
the distributed engines against the oracle, on the CPU.

* The port's ``SequentialEngine`` with ``compress_grads`` (flat, and with
  ``n_nodes``: the hierarchical reduction) against the JAX
  ``SequentialEngine`` over 3 steps from bridged parameters, each step
  from the JAX state, at the port-vs-JAX bounds of
  tests/test_torch_train.py (loss rtol 2e-4, parameters rtol 1e-3 / atol
  1e-5).
* ``DataParallelEngine`` (R = 2, plain and compressed) and
  ``MultiHostEngine`` (2 nodes x 2 devices, compressed), one gloo process
  per rank through ``launch.multihost.spawn_local``, against the port's
  ``SequentialEngine`` at the same R, at the JAX engine bounds of
  tests/test_engine.py (loss rtol 1e-5; parameters rtol 2e-5 / atol 1e-6
  plain, 1e-4 / 2e-5 compressed); every rank ends with the same
  parameters, bit for bit.
* The multi-process checkpoint: written at R = 2 (``meta.json``
  ``process_count`` 2, one shard per process), resumed by fresh trainers,
  equal to the uninterrupted run; a restore at R = 1 raises.
* ``launch.train`` as two processes takes 2 steps.

Every child process and the group's collectives run under a deadline.
Both the children and the oracle run on one thread, so that the CPU's
float sums are the same in both.
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mace import MaceConfig as JConfig
from repro.data.molecules import SyntheticCFMDataset as JDataset
from repro.train.checkpoint import _flatten as jflatten
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.bridge import JAX_ENGINE_NAMES, params_from_jax
from repro_torch.core.mace import MaceConfig
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.launch.multihost import spawn_local
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_loop import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 240
STEPS = 3
WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8, block_n=8, block_e=32, lr=2e-3)
N_GRAPHS, MAX_ATOMS = 48, 24

# (name, engine, n_ranks, n_nodes, compress): the distributed runs
RUNS = [("dp_plain", "data_parallel", 2, None, False),
        ("dp_compressed", "data_parallel", 2, None, True),
        ("mh_compressed", "multihost", 4, 2, True)]
BOUNDS = {False: (2e-5, 1e-6), True: (1e-4, 2e-5)}  # tests/test_engine.py:296-302,362

CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.mace import MaceConfig
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.launch.multihost import initialize_distributed
from repro_torch.train.checkpoint import flatten_state
from repro_torch.train.train_loop import Trainer, TrainerConfig

cfg = json.loads(sys.argv[1])
out = sys.argv[2]
initialize_distributed(backend="gloo", timeout_s=120)
rank = dist.get_rank()
widths = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["widths"].items()}
mace = MaceConfig(**widths, impl="cuda", interaction_impl="cuda")
ds = SyntheticCFMDataset(cfg["n_graphs"], seed=0, max_atoms=cfg["max_atoms"])

def trainer(ckpt_dir=None):
    tcfg = TrainerConfig(**cfg["train"], ckpt_dir=ckpt_dir, ckpt_every=0)
    return Trainer(mace, tcfg, ds, seed=0, device="cpu")

def dump(tag, tr, hist):
    state = {k: v.numpy() for k, v in flatten_state(tr._state()).items()}
    np.savez(f"{out}/{tag}.{rank}.npz", **state)
    tel = tr.telemetry
    with open(f"{out}/{tag}.{rank}.json", "w") as f:
        json.dump({"losses": [h["loss"] for h in hist], "loads": tel.loads,
                   "times": tel.times, "local": list(tr.engine.local_rank_range)}, f)

tr = trainer()
dump("run", tr, tr.train(n_epochs=1, max_steps=cfg["steps"])["history"])
if cfg["ckpt"]:
    # checkpoint after 2 steps, then resume in fresh trainers
    trainer(cfg["ckpt"]).train(n_epochs=1, max_steps=cfg["steps"] - 1)
    tr = trainer(cfg["ckpt"])
    assert tr.maybe_restore() and tr.global_step == cfg["steps"] - 1
    dump("resumed", tr, tr.train(n_epochs=1, max_steps=cfg["steps"])["history"])
dist.destroy_process_group()
"""


def _train_cfg(engine, n_ranks, n_nodes, compress):
    return dict(TRAIN, engine=engine, n_ranks=n_ranks, n_nodes=n_nodes,
                compress_grads=compress)


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    """Each distributed run's per-rank final state, losses and telemetry;
    the three groups run at once."""
    root = tmp_path_factory.mktemp("engines")
    spawned = {}
    for name, engine, n_ranks, n_nodes, compress in RUNS:
        out = root / name
        out.mkdir()
        cfg = dict(widths=WIDTHS, n_graphs=N_GRAPHS, max_atoms=MAX_ATOMS, steps=STEPS,
                   train=_train_cfg(engine, n_ranks, n_nodes, compress),
                   ckpt=str(out / "ckpt") if name == "dp_plain" else None)
        spawned[name] = (out, n_ranks, spawn_local(
            n_ranks, [sys.executable, "-c", CHILD, json.dumps(cfg), str(out)],
            env={"PYTHONPATH": str(REPO / "src")}, log_dir=str(out / "logs")))
    results = {}
    for name, (out, n_ranks, res) in spawned.items():
        codes = res.wait(timeout=DEADLINE_S)
        logs = "".join(Path(p.log_path).read_text()[-3000:] for p in res.procs)
        assert codes == [0] * n_ranks, f"{name}: {logs}"
        tags = ["run", "resumed"] if name == "dp_plain" else ["run"]
        results[name] = {tag: [(dict(np.load(out / f"{tag}.{r}.npz")),
                                json.loads((out / f"{tag}.{r}.json").read_text()))
                               for r in range(n_ranks)] for tag in tags}
        results[name]["dir"] = out
    return results


def _oracle(n_ranks, n_nodes, compress):
    """The port's sequential engine at R logical ranks, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tcfg = TrainerConfig(**_train_cfg("sequential", n_ranks, n_nodes, compress))
        tr = Trainer(MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda"), tcfg,
                     SyntheticCFMDataset(N_GRAPHS, seed=0, max_atoms=MAX_ATOMS),
                     seed=0, device="cpu")
        hist = tr.train(n_epochs=1, max_steps=STEPS)["history"]
    finally:
        torch.set_num_threads(threads)
    return tr, [h["loss"] for h in hist]


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_distributed_engine_matches_the_sequential_oracle(distributed, run):
    name, _, n_ranks, n_nodes, compress = run
    oracle, want_losses = _oracle(n_ranks, n_nodes, compress)
    want = {k: v.numpy() for k, v in ckpt.flatten_state(oracle._state()).items()}
    ranks = distributed[name]["run"]
    rtol, atol = BOUNDS[compress]
    state0, info0 = ranks[0]
    np.testing.assert_allclose(info0["losses"], want_losses, rtol=1e-5)
    for key, w in want.items():
        if key.startswith("ef/"):
            continue  # the oracle stacks every rank's residual; held below
        np.testing.assert_allclose(state0[key], w, rtol=rtol, atol=atol, err_msg=key)
    for r, (state, info) in enumerate(ranks):
        # a synchronous replica: every rank's parameters, optimizer state
        # and EMA are rank 0's, bit for bit, and so is each loss
        assert info["losses"] == info0["losses"]
        for key in state0:
            if not key.startswith("ef/"):
                np.testing.assert_array_equal(state[key], state0[key], err_msg=key)
        # the residual is this rank's row of the oracle's stack (per node
        # for the hierarchical reduction)
        row = r // (n_ranks // n_nodes) if n_nodes else r
        for key in (k for k in want if k.startswith("ef/")):
            assert state[key].shape[0] == 1
            np.testing.assert_allclose(state[key][0], want[key][row], rtol=rtol,
                                       atol=atol, err_msg=key)
        assert info["local"] == [r]            # each process collated its own bin
        # every rank holds every rank's loads, the oracle's per-rank loads
        assert info["loads"] == oracle.telemetry.loads
        assert np.asarray(info["times"]).shape == (STEPS, n_ranks)
    assert any(k.startswith("ef/") for k in want) == compress
    if compress:
        assert any(np.abs(state0[k]).max() > 0 for k in state0 if k.startswith("ef/"))


def test_multiprocess_checkpoint_resumes_and_refuses_another_world(distributed):
    run, resumed = distributed["dp_plain"]["run"], distributed["dp_plain"]["resumed"]
    for (state, info), (want, want_info) in zip(resumed, run):
        assert info["losses"] == want_info["losses"][STEPS - 1:]
        for key in want:
            np.testing.assert_allclose(state[key], want[key], rtol=1e-6, atol=1e-7,
                                       err_msg=key)
    d = str(distributed["dp_plain"]["dir"] / "ckpt")
    step, meta = ckpt.read_meta(d)
    assert step == STEPS and meta["process_count"] == 2 and meta["n_ranks"] == 2
    assert sorted(meta["checksums"]) == ["arrays.0.npz", "arrays.1.npz"]
    assert not [n for n in os.listdir(d) if n.startswith("tmp.")]
    for ckpt_ranks, match in [(1, "n_ranks=2"), (2, "2 process")]:
        tr = Trainer(MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda"),
                     TrainerConfig(**TRAIN, n_ranks=ckpt_ranks, ckpt_dir=d),
                     SyntheticCFMDataset(N_GRAPHS, seed=0, max_atoms=MAX_ATOMS),
                     seed=0, device="cpu")
        with pytest.raises(ValueError, match=match):
            tr.maybe_restore()
    with pytest.raises(ValueError, match="written by 2 process"):
        ckpt.restore_checkpoint(d, {})


def _leaf_rel(got, want):
    """Largest difference over the leaf's largest magnitude."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("n_ranks,n_nodes", [(2, None), (4, 2)])
def test_sequential_oracle_matches_the_jax_oracle(n_ranks, n_nodes):
    """Compressed gradients, flat and hierarchical, the fused impls on both
    sides, from bridged parameters.  Each of 3 steps is held in two parts
    from the JAX engine's state before it (as chip_smoke.py holds the card
    to the CPU): every rank's loss (rtol 2e-4) and gradients (2e-4 of each
    leaf's largest magnitude, tests/test_backward.py), then the reduction
    and the update from the JAX gradients: parameters, optimizer state and
    residuals at rtol 1e-3 / atol 1e-5.  Then the free-running trajectories'
    losses, rtol 2e-4.  Free running, the packages' float32 gradients
    differ in the last bits, which can move a value of ``c / scale`` across
    a rounding tie and its int8 payload by one step: a different input to
    the reduction, which the per-step check takes away."""
    kw = dict(TRAIN, n_ranks=n_ranks, n_nodes=n_nodes, compress_grads=True)
    jtr = JTrainer(JConfig(**WIDTHS, impl="fused", interaction_impl="fused"),
                   JTrainerConfig(**kw, engine="sequential"),
                   JDataset(N_GRAPHS, seed=0, max_atoms=MAX_ATOMS), seed=0)
    tr = Trainer(MaceConfig(**WIDTHS, impl="fused", interaction_impl="fused"),
                 TrainerConfig(**kw, engine=JAX_ENGINE_NAMES["sequential"]),
                 SyntheticCFMDataset(N_GRAPHS, seed=0, max_atoms=MAX_ATOMS),
                 seed=0, params=params_from_jax(jax.tree.map(np.asarray, jtr.params)),
                 device="cpu")
    jeng, eng = jtr.engine, tr.engine
    jstate = {"params": jtr.params, "opt_state": jtr.opt_state, "ef": jtr.ef_state}
    template = {"params": tr.params, "opt_state": tr.opt_state, "ef": tr.ef_state}
    lead = n_nodes or n_ranks
    assert all(e.shape[0] == lead for e in ckpt.flatten_state(tr.ef_state).values())
    steps = itertools.islice(jtr.sampler.step_iter(jtr.sampler_state), STEPS)
    for step, rank_bins in enumerate(steps):
        mols = [[tr.dataset.get(i) for i in b] for b in rank_bins]
        state = ckpt._unflatten(template, {k: np.array(v)
                                           for k, v in jflatten(jstate).items()})
        jgrads, jmetrics = [], []
        for jb, pb in zip(jeng.collate(mols, jtr.bin_shape)[0],
                          eng.to_device(eng.collate(mols, tr.bin_shape)[0])):
            (_, jm), jg = jeng._grad_fn(jstate["params"], jb)
            grads, metrics = eng.grads(state["params"], pb)
            np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=2e-4)
            jflat = jflatten(jg)
            assert grads.keys() == jflat.keys()
            for k, g in grads.items():
                assert _leaf_rel(g.numpy(), jflat[k]) <= 2e-4, (step, k)
            jgrads.append(jg)
            jmetrics.append(jm)
        want = jeng._finalize(jstate["params"], jstate["opt_state"], jstate["ef"],
                              jax.tree.map(lambda *g: jnp.stack(g), *jgrads),
                              jax.tree.map(lambda *m: jnp.stack(m), *jmetrics),
                              jnp.asarray(step))
        got = eng.finalize(
            state["params"], state["opt_state"], state["ef"],
            [{k: torch.from_numpy(np.array(v)) for k, v in jflatten(g).items()}
             for g in jgrads],
            [{k: torch.from_numpy(np.array(v)) for k, v in m.items()} for m in jmetrics],
            step)
        jstate = {"params": want[0], "opt_state": want[1], "ef": want[2]}
        got = ckpt.flatten_state({"params": got[0], "opt_state": got[1], "ef": got[2]})
        for k, w in jflatten(jstate).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {step}: {k}")
    jhist = jtr.train(n_epochs=1, max_steps=STEPS)["history"]
    hist = tr.train(n_epochs=1, max_steps=STEPS)["history"]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=2e-4)


def test_engine_names_and_the_cluster_entry_point(tmp_path):
    assert JAX_ENGINE_NAMES == {"sequential": "sequential", "shard_map": "data_parallel",
                                "multihost": "multihost"}
    with pytest.raises(KeyError, match="unknown engine"):
        Trainer(MaceConfig(**WIDTHS), TrainerConfig(**TRAIN, engine="shard_map"),
                SyntheticCFMDataset(4, seed=0, max_atoms=8), device="cpu")
    with pytest.raises(RuntimeError, match="not initialised"):
        Trainer(MaceConfig(**WIDTHS), TrainerConfig(**TRAIN, engine="data_parallel"),
                SyntheticCFMDataset(4, seed=0, max_atoms=8), device="cpu")
    cmd = [sys.executable, "-m", "repro_torch.launch.multihost", "--nprocs", "2",
           "--timeout", str(DEADLINE_S), "--", sys.executable, "-m",
           "repro_torch.launch.train", "--distributed", "--device", "cpu",
           "--num-processes", "2", "--reduced", "--steps", "2", "--compress-grads",
           "--ckpt-dir", str(tmp_path / "run")]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=DEADLINE_S + 30,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("done: 2 steps, engine data_parallel, ranks 2") == 2
    assert "backend gloo" in proc.stdout
    assert ckpt.read_meta(str(tmp_path / "run"))[1]["process_count"] == 2


def test_training_driver_starts_its_ranks(tmp_path):
    """``train_mace_cfm --nprocs 2`` starts two ranks of one group through
    ``spawn_local``; a sequential engine across processes is refused."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train_mace_cfm", "--device", "cpu",
           "--nprocs", "2", "--engine", "multihost", "--n-nodes", "2",
           "--compress-grads", "--steps", "2", "--n-graphs", "16", "--capacity", "48",
           "--channels", "4", "--max-atoms", "24", "--prefetch", "0"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("engine=multihost ranks=2 nodes=2 compress=True") == 2
    assert "process 0: exit 0" in proc.stdout and "process 1: exit 0" in proc.stdout
    proc = subprocess.run(cmd[:5] + ["--nprocs", "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "sequential engine runs in one process" in proc.stderr
