"""Port parity, the training slice: optimizer, samplers, prefetch,
checkpoints (in both directions between the packages), the ``Trainer``
trajectory against the JAX ``Trainer`` with bridged parameters, restart
after a failure, and the training driver, all on the CPU (the port's plain
versions; the JAX package's Pallas kernels in interpret mode).

Tolerances: the optimizer rtol 1e-6 (the same float32 algebra); the
3-step trajectory those of tests/test_engine.py:472 for two impls that
reassociate float32 sums (loss rtol 2e-4, parameters rtol 1e-3 / atol
1e-5); restart after a failure those of tests/test_train.py:155.
"""
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.binpack import fixed_count_batches as jfixed
from repro.core.mace import MaceConfig as JConfig
from repro.data.molecules import SyntheticCFMDataset as JDataset
from repro.data.sampler import BalancedBatchSampler as JBalanced
from repro.data.sampler import FixedCountSampler as JFixed
from repro.data.sampler import SamplerState as JState
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.checkpoint import _flatten as jflatten
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.core.binpack import fixed_count_batches
from repro_torch.core.mace import MaceConfig
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.data.prefetch import PrefetchPipeline
from repro_torch.data.sampler import BalancedBatchSampler, FixedCountSampler, SamplerState
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPT_CASES = {
    # name: (clip norm, weight decay, schedule)
    "adamw_constant": (1e6, 0.0, "constant"),
    "clipped_weight_decay": (0.5, 0.01, "constant"),
    "warmup_cosine": (10.0, 0.0, "cosine"),
    "exponential_decay": (10.0, 0.0, "exponential"),
}


def _schedule(mod, name):
    return {"constant": 5e-3,
            "cosine": mod.warmup_cosine_lr(5e-3, warmup=2, total=6),
            "exponential": mod.exponential_decay_lr(5e-3, 0.5, 2)}[name]


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizer_matches_jax(name):
    """chain(clip, adamw) + EMA, 3 steps on one numpy tree of parameters
    and gradients, both packages."""
    clip, wd, sched = OPT_CASES[name]
    rng = np.random.default_rng(len(name))
    tree = {"a": rng.normal(size=(3, 4)), "b": {"c": rng.normal(size=(5,)),
                                               "d": rng.normal(size=(2, 2))}}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32), tree)
             for _ in range(3)]

    def run_jax():
        o = jopt.chain(jopt.clip_by_global_norm(clip),
                       jopt.adamw(_schedule(jopt, sched), weight_decay=wd))
        params = jax.tree.map(jnp.asarray, tree)
        state, e = o.init(params), jopt.EMA(0.99)
        ema = e.init(params)
        for i, g in enumerate(grads):
            upd, state = o.update(jax.tree.map(jnp.asarray, g), state, params,
                                  jnp.asarray(i))
            params = jopt.apply_updates(params, upd)
            ema = e.update(ema, params, jnp.asarray(i))
        return [np.asarray(x) for x in jax.tree.leaves((params, state, ema))]

    def run_port():
        o = opt.chain(opt.clip_by_global_norm(clip),
                      opt.adamw(_schedule(opt, sched), weight_decay=wd))
        params = opt.tree_map(torch.from_numpy, tree)
        state, e = o.init(params), opt.EMA(0.99)
        ema = e.init(params)
        for i, g in enumerate(grads):
            upd, state = o.update(opt.tree_map(torch.from_numpy, g), state, params, i)
            params = opt.apply_updates(params, upd)
            ema = e.update(ema, params, i)
        return [t.numpy() for t in opt.tree_leaves((params, state, ema))]

    want, got = run_jax(), run_port()
    assert len(got) == len(want) == 3 * 4  # params, m, v, EMA
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)


def test_adam_update_amplifies_rounding_of_gradients_near_eps():
    """Why the card-against-CPU check of chip_smoke.py compares each step's
    gradients and update rather than free-running parameters: near |g| =
    eps, a change of 4e-10 in a gradient (float32's resolution at 1e-2, the
    size of the largest entries of such a gradient's leaf) moves Adam's
    first update by more than the parameter bound (atol 2e-5)."""
    o = opt.adamw(5e-3)
    params = {"w": torch.zeros(2)}
    state = o.init(params)
    upd, _ = o.update({"w": torch.tensor([1.3e-8, 1.3e-8 + 4e-10])}, state, params, 0)
    assert float((upd["w"][1] - upd["w"][0]).abs()) > 2e-5


def test_optimizer_moves_toward_the_minimum():
    o = opt.adamw(0.1)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = o.init(params)
    for i in range(200):
        upd, state = o.update({"x": 2 * params["x"]}, state, params, i)
        params = opt.apply_updates(params, upd)
    assert float(params["x"].abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# samplers, baseline packing, prefetch
# ---------------------------------------------------------------------------

SIZES = JDataset(300, seed=4, max_atoms=64).sizes


@pytest.mark.parametrize("seed", [0, 5])
def test_fixed_count_batches_match_jax(seed):
    for shuffle in (False, True):
        want = jfixed(SIZES, 7, 3, shuffle=shuffle, seed=seed)
        got = fixed_count_batches(SIZES, 7, 3, shuffle=shuffle, seed=seed)
        assert got.bins == want.bins and got.capacity == want.capacity


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_samplers_give_the_reference_bins(n_ranks):
    assert np.array_equal(SyntheticCFMDataset(300, seed=4, max_atoms=64).sizes, SIZES)
    pairs = [(BalancedBatchSampler(SIZES, 128, n_ranks, seed=3),
              JBalanced(SIZES, 128, n_ranks, seed=3)),
             (FixedCountSampler(SIZES, 5, n_ranks, seed=3),
              JFixed(SIZES, 5, n_ranks, seed=3))]
    for ours, theirs in pairs:
        for epoch in (0, 1):
            assert ours.bins_for_epoch(epoch) == theirs.bins_for_epoch(epoch)
            assert ours.steps_per_epoch(epoch) == theirs.steps_per_epoch(epoch)
            assert (list(ours.step_iter(SamplerState(epoch, 2)))
                    == list(theirs.step_iter(JState(epoch, 2))))
            assert (list(ours.epoch_iter(n_ranks - 1, SamplerState(epoch, 1)))
                    == list(theirs.epoch_iter(n_ranks - 1, JState(epoch, 1))))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_stream_is_the_inline_stream_and_raises_in_order(depth):
    with PrefetchPipeline(range(6), lambda x: x * 10, depth=depth) as pipe:
        assert [it.batch for it in pipe] == [0, 10, 20, 30, 40, 50]

    def fetch(x):
        if x == 3:
            raise KeyError("bad molecule")
        return x

    got = []
    with pytest.raises(KeyError):
        with PrefetchPipeline(range(6), fetch, depth=depth) as pipe:
            for it in pipe:
                got.append(it.batch)
    assert got == [0, 1, 2]


def test_prefetch_keeps_an_error_in_flight_at_an_early_exit():
    def fetch(x):
        if x == 1:
            raise KeyError("bad molecule")
        return x

    pipe = PrefetchPipeline(range(3), fetch, depth=2)
    assert next(pipe).batch == 0
    deadline = time.monotonic() + 10
    while pipe._queue.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.close()                      # early exit: the error is still queued
    with pytest.raises(KeyError):
        pipe.raise_pending()
    pipe.raise_pending()              # raised once only


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"a": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
                       "n": {"b": torch.ones(2, 2)}},
            "opt_state": ((), {"m": {"a": torch.zeros(5)}, "v": {"a": torch.full((5,), 2.0)}})}


def test_checkpoint_round_trip_and_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _state()
    for s in (10, 20, 30, 40):
        ckpt.save_checkpoint(d, s, state, meta={"tag": s}, keep=2)
    assert ckpt.latest_step(d) == 40
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        "step_0000000030", "step_0000000040"]
    step, restored, meta = ckpt.restore_checkpoint(d, _state(seed=1))
    assert step == 40 and meta["tag"] == 40 and meta["process_count"] == 1
    assert isinstance(restored["opt_state"], tuple) and restored["opt_state"][0] == ()
    for key, want in ckpt.flatten_state(state).items():
        got = ckpt.flatten_state(restored)[key]
        assert got.dtype == want.dtype and torch.equal(got, want), key


def test_checkpoint_ignores_uncommitted_and_rejects_shape_mismatch(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 1, {"a": torch.zeros(2)})
    os.makedirs(os.path.join(d, "step_0000000099"))  # a crashed, uncommitted write
    assert ckpt.latest_step(d) == 1
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(d, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(d, {"b": torch.zeros(2)})


def test_checkpoint_falls_back_past_a_corrupt_payload(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 1, {"a": torch.zeros(4)})
    ckpt.save_checkpoint(d, 2, {"a": torch.ones(4)})
    path = os.path.join(d, "step_0000000002", "arrays.0.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert ckpt.verify_payload(d, 2) is not None and ckpt.verify_payload(d, 1) is None
    with pytest.warns(RuntimeWarning, match="corrupt"):
        step, state, _ = ckpt.restore_checkpoint(d, {"a": torch.zeros(4)})
    assert step == 1 and torch.equal(state["a"], torch.zeros(4))
    path = os.path.join(d, "step_0000000001", "arrays.0.npz")
    open(path, "ab").write(b"x")
    with pytest.warns(RuntimeWarning), pytest.raises(RuntimeError, match="every committed"):
        ckpt.restore_checkpoint(d, {"a": torch.zeros(4)})


def test_checkpoints_restore_across_the_packages(tmp_path):
    """A JAX-written checkpoint restores into the port's tree, and a
    port-written one into the JAX tree: same paths, bits and meta."""
    state = _state(seed=2)
    jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, jstate, meta={"sampler": {"epoch": 0}})
    step, got, meta = ckpt.restore_checkpoint(str(tmp_path / "j"), _state(seed=3))
    assert step == 7 and meta["sampler"] == {"epoch": 0}
    ckpt.save_checkpoint(str(tmp_path / "t"), 8, state, meta={"n_ranks": 1})
    step, jgot, meta = jckpt.restore_checkpoint(
        str(tmp_path / "t"), jax.tree.map(jnp.zeros_like, jstate))
    assert step == 8 and meta["n_ranks"] == 1
    want = jflatten(jstate)
    assert ckpt.flatten_state(got).keys() == want.keys() == jflatten(jgot).keys()
    for key in want:
        np.testing.assert_array_equal(ckpt.flatten_state(got)[key].numpy(), want[key])
        np.testing.assert_array_equal(np.asarray(jflatten(jgot)[key]), want[key])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
JCFG = JConfig(**WIDTHS, impl="pallas", interaction_impl="pallas",
               interaction_bwd_impl="pallas", precision="fp32")
TCFG = MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
# edge_factor 16 keeps the interpret-mode grids small (tests/test_engine.py)
TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8, block_n=8, block_e=32)


@functools.lru_cache(maxsize=None)
def _jax_run(steps=3):
    """The JAX ``Trainer``'s initial parameters, per-step losses and final
    state over ``steps`` steps."""
    tr = JTrainer(JCFG, JTrainerConfig(**TRAIN), JDataset(24, seed=0, max_atoms=24), seed=0)
    init = jax.tree.map(np.asarray, tr.params)
    hist = tr.train(n_epochs=1, max_steps=steps)["history"]
    final = {k: np.asarray(v) for k, v in jflatten(
        {"params": tr.params, "opt_state": tr.opt_state, "ema": tr.ema_params}).items()}
    return init, [h["loss"] for h in hist], final


@functools.lru_cache(maxsize=None)
def _jax_state_template():
    tr = JTrainer(JCFG, JTrainerConfig(**TRAIN), JDataset(24, seed=0, max_atoms=24), seed=0)
    return jax.tree.map(jnp.zeros_like, {"params": tr.params, "opt_state": tr.opt_state,
                                         "ema": tr.ema_params, "ef": ()})


def _port_trainer(tmp_path=None, prefetch=0, **kw):
    tcfg = TrainerConfig(**TRAIN, prefetch=prefetch,
                         ckpt_dir=None if tmp_path is None else str(tmp_path), **kw)
    return Trainer(TCFG, tcfg, SyntheticCFMDataset(24, seed=0, max_atoms=24), seed=0,
                   params=params_from_jax(_jax_run()[0]), device="cpu")


@pytest.mark.parametrize("prefetch", [0, 1])
def test_trainer_trajectory_matches_the_jax_trainer(prefetch, tmp_path):
    _, want_losses, want = _jax_run()
    tr = _port_trainer(tmp_path, prefetch=prefetch)
    hist = tr.train(n_epochs=1, max_steps=3)["history"]
    np.testing.assert_allclose([h["loss"] for h in hist], want_losses, rtol=2e-4)
    assert all(np.isfinite(h[k]) for h in hist for k in ("e_rmse", "f_rmse"))
    got = ckpt.flatten_state(tr._state())
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-3, atol=1e-5,
                                   err_msg=key)
    assert tr.telemetry.n_steps == 3 and tr.telemetry.c_token() > 0
    # the final checkpoint restores into the JAX trainer's tree
    step, jstate, meta = jckpt.restore_checkpoint(str(tmp_path), _jax_state_template())
    assert step == 3 and meta["sampler"] == {"epoch": 0, "cursor": 3}
    for key, val in jflatten(jstate).items():
        np.testing.assert_array_equal(np.asarray(val), got[key].numpy())


def test_failure_restart_equals_an_uninterrupted_run(tmp_path):
    """Kill at step 4, restart from the step-2 checkpoint, and end where an
    uninterrupted run ends."""
    ref = _port_trainer(tmp_path / "ref", ckpt_every=2)
    ref.train(n_epochs=1, max_steps=6)
    crash = _port_trainer(tmp_path / "crash", ckpt_every=2)
    with pytest.raises(RuntimeError, match="simulated"):
        crash.train(n_epochs=1, max_steps=6, simulate_failure_at=4)
    resumed = _port_trainer(tmp_path / "crash", ckpt_every=2)
    assert resumed.maybe_restore()
    # the failure hit before the step-4 checkpoint: resume from 2, replay 3-4
    assert resumed.global_step == 2 and resumed.sampler_state.cursor == 2
    resumed.train(n_epochs=1, max_steps=6)
    a, b = ckpt.flatten_state(ref._state()), ckpt.flatten_state(resumed._state())
    for key in a:
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), rtol=1e-6, atol=1e-7)


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TCFG, TrainerConfig(**TRAIN), SyntheticCFMDataset(4, seed=0, max_atoms=8))


def test_fixed_sampler_trainer_takes_finite_steps():
    tcfg = TrainerConfig(**dict(TRAIN, max_graphs=4), fixed_graphs_per_batch=3)
    tr = Trainer(TCFG, tcfg, SyntheticCFMDataset(12, seed=1, max_atoms=16),
                 sampler="fixed", device="cpu")
    hist = tr.train(n_epochs=1, max_steps=2)["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_training_driver_takes_two_steps_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train_mace_cfm", "--device", "cpu",
           "--steps", "2", "--n-graphs", "16", "--capacity", "48", "--channels", "4",
           "--max-atoms", "24", "--prefetch", "1",
           "--ckpt-dir", str(tmp_path / "run")]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final loss=" in proc.stdout and "device=cpu" in proc.stdout
    assert ckpt.latest_step(str(tmp_path / "run")) == 2
    # a second run resumes from the checkpoint
    proc = subprocess.run(cmd[:6] + ["3"] + cmd[7:], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resumed from step 2" in proc.stdout
    assert ckpt.latest_step(str(tmp_path / "run")) == 3
