"""Port parity, elastic rescale: the counterparts of tests/test_rescale.py on
the CPU, against the JAX package at small widths.

* The samplers' ``with_ranks`` and ``rescale`` give the JAX bins exactly,
  for the three samplers at (R_old, R_new) in {1, 2, 3, 4}^2, chained
  remaps included; the remap drops and duplicates no graph (the JAX
  hypothesis property).
* ``parse_rescale_schedule``, ``RankTelemetry.record_rescale`` and
  ``merged``; ``data/prefetch.py`` is the JAX module (the docstring aside),
  with its ``discarded`` count and stall watchdog.
* Checkpoints across rank counts: meta, the exact restore of parameters,
  optimizer state and EMA with the residuals re-initialised, the refusal
  without ``elastic``; a restart at the rescale boundary fires the
  schedule again.
* The port's ``ElasticTrainer`` on ``sequential`` (R = 2 -> 1 and 2 -> 4,
  prefetch 0 and 1, from bridged parameters) against the JAX
  ``ElasticTrainer`` with the same schedule, at the bounds of
  tests/test_torch_train.py::test_trainer_trajectory_matches_the_jax_trainer
  (loss rtol 2e-4, parameters rtol 1e-3 / atol 1e-5).  The JAX side runs
  the ``fused`` impls (its plain reference of the Pallas kernels).
* A 2-process gloo ``data_parallel`` run killed after a checkpoint and
  restarted as 1 process with ``elastic``, against the sequential oracle
  with the same schedule, at the JAX engine bounds of tests/test_engine.py
  (loss rtol 1e-5, parameters rtol 2e-5 / atol 1e-6); there
  ``Trainer.rescale`` refuses another rank count and names the restart
  route.

Every child process and the group's collectives run under a deadline.  The
port's CPU steps run on one thread, in the children and here: these widths
gain nothing from more, and a test run shares the cores with other files.
"""
import functools
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.mace import MaceConfig as JConfig
from repro.data.molecules import SyntheticCFMDataset as JDataset
from repro.data.sampler import BalancedBatchSampler as JBalanced
from repro.data.sampler import FixedCountSampler as JFixed
from repro.data.sampler import HierarchicalBalancedSampler as JHier
from repro.data.sampler import SamplerState as JState
from repro.train.checkpoint import _flatten as jflatten
from repro.train.train_loop import ElasticTrainer as JElasticTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro.train.train_loop import parse_rescale_schedule as jparse
from repro_torch.bridge import params_from_jax
from repro_torch.core.mace import MaceConfig
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.data.prefetch import PrefetchPipeline, ProducerStalled
from repro_torch.data.sampler import (
    BalancedBatchSampler,
    FixedCountSampler,
    HierarchicalBalancedSampler,
    SamplerState,
)
from repro_torch.launch.multihost import spawn_local
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.engine import MergedTelemetry, RankTelemetry
from repro_torch.train.train_loop import (
    ElasticTrainer,
    Trainer,
    TrainerConfig,
    parse_rescale_schedule,
)
from tests.hypothesis_support import given, settings, st

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 240
WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
PCFG = MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
JCFG = JConfig(**WIDTHS, impl="fused", interaction_impl="fused")
TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8, block_n=8, block_e=32)
N_GRAPHS, MAX_ATOMS = 24, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sizes(n=200, seed=0, lo=4, hi=60):
    return np.random.default_rng(seed).integers(lo, hi, size=n)


def _stream_indices(sampler, state):
    """Every graph index the sampler yields from ``state`` on."""
    return [i for grp in sampler.step_iter(state) for b in grp for i in b]


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

SAMPLERS = {
    "balanced": (lambda m, s, r: m(s, 128, r, seed=3)),
    "fixed": (lambda m, s, r: m(s, 5, r, seed=3)),
    # 2 ranks per node: R = 3 degrades to a flat packing, as in JAX
    "hierarchical": (lambda m, s, r: m(s, 128, r // 2, 2, seed=3) if r % 2 == 0
                     else None),
}
CLASSES = {"balanced": (BalancedBatchSampler, JBalanced),
           "fixed": (FixedCountSampler, JFixed),
           "hierarchical": (HierarchicalBalancedSampler, JHier)}
PAIRS = [(a, b) for a in (1, 2, 3, 4) for b in (1, 2, 3, 4)]


def _pair(kind, sizes, r):
    port_cls, jax_cls = CLASSES[kind]
    make = SAMPLERS[kind]
    if make(port_cls, sizes, r) is None:  # hierarchical needs whole nodes
        return (make(port_cls, sizes, 2).with_ranks(r), make(jax_cls, sizes, 2).with_ranks(r))
    return make(port_cls, sizes, r), make(jax_cls, sizes, r)


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
@pytest.mark.parametrize("r_old,r_new", PAIRS)
def test_with_ranks_and_rescale_give_the_jax_bins(kind, r_old, r_new):
    sizes = _sizes(90, seed=r_old * 7 + r_new)
    port, ref = _pair(kind, sizes, r_old)
    for epoch in (0, 1):
        assert port.bins_for_epoch(epoch) == ref.bins_for_epoch(epoch)
    wp, wj = port.with_ranks(r_new), ref.with_ranks(r_new)
    assert type(wp).__name__ == type(wj).__name__
    assert wp.bins_for_epoch(0) == wj.bins_for_epoch(0)
    cursor = port.steps_per_epoch(0) // 2
    # a chain: R_old -> R_new mid-epoch, then -> R_old again, in one epoch
    p2, ps = port.rescale(r_new, SamplerState(0, cursor))
    j2, js = ref.rescale(r_new, JState(0, cursor))
    assert type(p2).__name__ == type(j2).__name__
    assert (ps.epoch, ps.cursor) == (js.epoch, js.cursor) == (0, 0)
    assert p2.bins_for_epoch(0) == j2.bins_for_epoch(0)
    assert p2.bins_for_epoch(1) == j2.bins_for_epoch(1)   # full packing again
    c2 = p2.steps_per_epoch(0) // 2
    p3, _ = p2.rescale(r_old, SamplerState(0, c2))
    j3, _ = j2.rescale(r_old, JState(0, c2))
    assert p3.bins_for_epoch(0) == j3.bins_for_epoch(0)
    # consumed prefixes + the last stream cover the epoch exactly once
    seen = (port.consumed_indices(SamplerState(0, cursor))
            + p2.consumed_indices(SamplerState(0, c2))
            + _stream_indices(p3, SamplerState(0, 0)))
    assert sorted(seen) == list(range(len(sizes)))


def test_rescale_at_epoch_end_yields_empty_remainder():
    sizes = _sizes(60, seed=5)
    s = BalancedBatchSampler(sizes, 128, 2, seed=0)
    s2, st2 = s.rescale(3, SamplerState(0, s.steps_per_epoch(0)))
    assert s2.steps_per_epoch(0) == 0 and _stream_indices(s2, st2) == []
    assert sorted(_stream_indices(s2, SamplerState(1, 0))) == list(range(len(sizes)))


@settings(max_examples=30, deadline=None)
@given(
    sizes=st.lists(st.integers(min_value=1, max_value=64), min_size=1, max_size=120),
    r_old=st.integers(min_value=1, max_value=6),
    r_new=st.integers(min_value=1, max_value=6),
    cursor_frac=st.floats(min_value=0.0, max_value=1.0),
)
def test_rescale_remap_property(sizes, r_old, r_new, cursor_frac):
    """For random datasets and any (R_old, R_new): the remap neither drops
    nor duplicates a graph, and the bins are the JAX sampler's."""
    s = BalancedBatchSampler(np.asarray(sizes), 64, r_old, seed=2)
    assert sorted(_stream_indices(s, SamplerState(0, 0))) == list(range(len(sizes)))
    cursor = int(round(cursor_frac * s.steps_per_epoch(0)))
    consumed = s.consumed_indices(SamplerState(0, cursor))
    s2, st2 = s.rescale(r_new, SamplerState(0, cursor))
    assert sorted(consumed + _stream_indices(s2, st2)) == list(range(len(sizes)))
    j2, _ = JBalanced(np.asarray(sizes), 64, r_old, seed=2).rescale(r_new, JState(0, cursor))
    assert s2.bins_for_epoch(0) == j2.bins_for_epoch(0)


# ---------------------------------------------------------------------------
# schedule, telemetry, prefetch
# ---------------------------------------------------------------------------

SPECS = [[], "", "10:4", ["10:4,20:2", "30:8"], " 3:1 , ", "10", "0:4", "5:-1", "a:b"]


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_parse_rescale_schedule_matches_jax(spec):
    spec = SPECS[spec]
    try:
        want = jparse(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            parse_rescale_schedule(spec)
        assert str(got.value) == str(exc)
    else:
        assert parse_rescale_schedule(spec) == want


def test_rank_telemetry_records_rescale_events_and_merges():
    t = RankTelemetry(2)
    assert t.rescale_seconds() == (0.0, 0.0)
    t.record_rescale(0.5, 1.5)
    t.record_rescale(0.25, 0.75)
    assert t.rescale_repack == [0.5, 0.25] and t.rescale_seconds() == (0.75, 2.25)
    with pytest.raises(ValueError):
        RankTelemetry.merged()
    a, b = RankTelemetry(2), RankTelemetry(1)
    for step in range(3):
        a.record([1.0 + step, 3.0], [10.0, 30.0])
        a.record_host(0.5, 0.1, 0.05)
    for _ in range(2):
        b.record([2.0], [20.0])
        b.record_host(0.2, 0.2)
    b.record_rescale(0.01, 0.5)
    m = RankTelemetry.merged(a, b)
    assert isinstance(m, MergedTelemetry)
    assert m.n_generations == 2 and m.n_steps == 5
    assert [w.shape for w in m.work_matrices()] == [(3, 2), (2, 1)]
    assert [w.shape for w in m.load_matrices(skip=1)] == [(2, 2), (1, 1)]
    # sums over the whole run before dividing
    assert m.c_token() == pytest.approx((4 + 5 + 6 + 4) / (3 * 40 + 2 * 20))
    ratios = [3 / 2, 3 / 2.5, 1.0, 1.0, 1.0]  # max/mean per step, b's one rank
    assert m.measured_straggler() == pytest.approx(float(np.mean(ratios)))
    assert m.host_matrix().shape == (5, 2)
    assert m.overlap_seconds() == pytest.approx(3 * 0.4)
    assert m.overlap_fraction() == pytest.approx(1.2 / (1.5 + 0.4))
    assert m.blocking_seconds() == pytest.approx(0.15)
    assert m.rescale_seconds() == (0.01, 0.5)


def test_prefetch_module_is_the_reference_module():
    """``data/prefetch.py`` is the JAX module statement for statement (the
    docstring aside)."""
    import ast
    import inspect

    import repro.data.prefetch as jprefetch
    import repro_torch.data.prefetch as tprefetch

    def body(module):
        tree = ast.parse(inspect.getsource(module))
        tree.body = tree.body[1:]
        return ast.dump(tree)

    assert body(tprefetch) == body(jprefetch)


def test_prefetch_close_counts_discarded_batches():
    p = PrefetchPipeline(range(10), lambda i: i * 2, depth=3)
    assert next(p).batch == 0
    deadline = time.time() + 5.0
    while p._queue.qsize() < 3 and time.time() < deadline:
        time.sleep(0.01)
    p.close()
    assert p.discarded >= 1  # in-flight batches were drained, not delivered
    q = PrefetchPipeline(range(3), lambda i: i, depth=0)
    next(q)
    q.close()
    assert q.discarded == 0


def test_prefetch_stall_watchdog_raises_once_and_close_stays_bounded():
    with pytest.raises(ValueError, match="positive"):
        PrefetchPipeline(range(2), lambda i: i, depth=1, stall_deadline_s=0)
    release = __import__("threading").Event()

    def fetch(i):
        if i == 1:
            release.wait(30.0)  # a wedged data source
        return i

    p = PrefetchPipeline(range(4), fetch, depth=1, stall_deadline_s=0.2)
    assert next(p).batch == 0
    time.sleep(0.5)
    msg = p.stalled()
    assert msg is not None and "item 1" in msg
    with pytest.raises(ProducerStalled, match="item 1"):
        p.raise_pending()
    p.raise_pending()  # delivered once
    t0 = time.monotonic()
    p.close()  # abandons the wedged daemon thread instead of joining it
    assert time.monotonic() - t0 < 5.0
    assert isinstance(p.error, ProducerStalled)
    release.set()


# ---------------------------------------------------------------------------
# checkpoints across rank counts
# ---------------------------------------------------------------------------


def _ckpt_trainer(tmp_path, n_ranks, *, elastic=True, seed=0):
    # tests/test_rescale.py's sizes: the remainder at R = 2 packs whole steps
    tcfg = TrainerConfig(**dict(TRAIN, capacity=64), n_ranks=n_ranks, compress_grads=True,
                         elastic=elastic, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=0)
    return Trainer(PCFG, tcfg, SyntheticCFMDataset(48, seed=1, max_atoms=48),
                   seed=seed, device="cpu")


def _leaves(tree):
    return {k: v for k, v in ckpt.flatten_state(tree).items()}


def test_checkpoint_meta_round_trip_across_ranks(tmp_path):
    """Saved at R = 4, restored at R = 2: parameters, optimizer state and
    EMA exact, the residuals re-initialised at the new rank count, the
    cursor remapped with no graph lost, the lineage carried onward."""
    saver = _ckpt_trainer(tmp_path, 4, seed=7)
    with torch.no_grad():
        for p in _leaves(saver.params).values():
            p += 0.125
        for e in _leaves(saver.ef_state).values():
            e += 1.0
    saver.global_step = 3
    saver.sampler_state = SamplerState(epoch=0, cursor=2)
    saver.save()
    step, meta = ckpt.read_meta(str(tmp_path / "ckpt"))
    assert step == 3 and meta["n_ranks"] == 4 and meta["process_count"] == 1
    assert meta["sampler"] == {"epoch": 0, "cursor": 2} and meta["lineage"] == []

    resumed = _ckpt_trainer(tmp_path, 2, seed=0)
    assert resumed.maybe_restore() and resumed.global_step == 3
    for name in ("params", "opt_state", "ema_params"):
        want, got = _leaves(getattr(saver, name)), _leaves(getattr(resumed, name))
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), (name, k)
    for e in _leaves(resumed.ef_state).values():
        assert e.shape[0] == 2 and float(e.abs().max()) == 0.0
    assert resumed.sampler_state == SamplerState(0, 0)
    consumed = saver.sampler.consumed_indices(SamplerState(0, 2))
    remaining = _stream_indices(resumed.sampler, resumed.sampler_state)
    assert sorted(consumed + remaining) == list(range(48))
    assert resumed._lineage == [{"n_ranks": 4, "cursor": 2}]


def test_same_rank_restore_keeps_the_residuals(tmp_path):
    saver = _ckpt_trainer(tmp_path, 2, seed=7)
    with torch.no_grad():
        for e in _leaves(saver.ef_state).values():
            e += 1.0
    saver.save()
    resumed = _ckpt_trainer(tmp_path, 2, seed=0)
    assert resumed.maybe_restore()
    for e in _leaves(resumed.ef_state).values():
        assert torch.equal(e, torch.ones_like(e))


def test_restore_across_ranks_requires_elastic(tmp_path):
    _ckpt_trainer(tmp_path, 4, seed=7).save()
    rigid = _ckpt_trainer(tmp_path, 2, elastic=False)
    with pytest.raises(ValueError, match="n_ranks=4.*elastic"):
        rigid.maybe_restore()
    assert _ckpt_trainer(tmp_path, 4, elastic=False).maybe_restore()


def _elastic(tmp_path=None, schedule=None, prefetch=1, params=None):
    tcfg = TrainerConfig(**TRAIN, n_ranks=2, prefetch=prefetch, elastic=True,
                         ckpt_dir=None if tmp_path is None else str(tmp_path),
                         ckpt_every=0)
    return ElasticTrainer(PCFG, tcfg, SyntheticCFMDataset(N_GRAPHS, seed=0,
                                                          max_atoms=MAX_ATOMS),
                          rescale_schedule=schedule, seed=0, params=params, device="cpu")


def test_restart_at_the_rescale_boundary_fires_the_schedule_again(tmp_path):
    """A crash during the engine rebuild restores the snapshot ``rescale``
    writes first; the same schedule re-applies the pending rescale before
    stepping and ends on the uninterrupted run's parameters."""
    first = _elastic(tmp_path, {2: 3})

    def crash_rescale(n_ranks):
        first.save()
        raise RuntimeError("crash during rebuild")

    first.rescale = crash_rescale
    with pytest.raises(RuntimeError, match="crash during rebuild"):
        first.train(n_epochs=1, max_steps=4)
    assert ckpt.latest_step(str(tmp_path)) == 2
    again = _elastic(tmp_path, {2: 3})
    assert again.maybe_restore() and again.global_step == 2
    again.train(n_epochs=1, max_steps=4)
    assert again.engine.n_ranks == 3 and [e["step"] for e in again.rescale_events] == [2]
    oracle = _elastic(None, {2: 3})
    oracle.train(n_epochs=1, max_steps=4)
    a, b = _leaves(oracle._state()), _leaves(again._state())
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the ElasticTrainer against the JAX one
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(r_new):
    """The JAX ``ElasticTrainer`` from R = 2, rescaled after step 2:
    initial parameters, per-step losses, final state and events."""
    tr = JElasticTrainer(JCFG, JTrainerConfig(**TRAIN, n_ranks=2),
                         JDataset(N_GRAPHS, seed=0, max_atoms=MAX_ATOMS), seed=0,
                         rescale_schedule={2: r_new})
    init = jax.tree.map(np.asarray, tr.params)
    hist = tr.train(n_epochs=1, max_steps=4)["history"]
    final = {k: np.asarray(v) for k, v in jflatten(
        {"params": tr.params, "opt_state": tr.opt_state, "ema": tr.ema_params}).items()}
    events = [{k: e[k] for k in ("step", "from_ranks", "to_ranks")}
              for e in tr.rescale_events]
    bins = tr.sampler.bins_for_epoch(0)
    return init, [h["loss"] for h in hist], final, events, bins


@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("r_new", [1, 4])
def test_elastic_trainer_matches_the_jax_elastic_trainer(r_new, prefetch):
    init, want_losses, want, want_events, want_bins = _jax_run(r_new)
    tr = _elastic(schedule={2: r_new}, prefetch=prefetch, params=params_from_jax(init))
    hist = tr.train(n_epochs=1, max_steps=4)["history"]
    assert len(hist) == len(want_losses) == 4
    np.testing.assert_allclose([h["loss"] for h in hist], want_losses, rtol=2e-4)
    got = _leaves({"params": tr.params, "opt_state": tr.opt_state, "ema": tr.ema_params})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert [{k: e[k] for k in ("step", "from_ranks", "to_ranks")}
            for e in tr.rescale_events] == want_events
    assert tr.sampler.bins_for_epoch(0) == want_bins
    assert tr.engine.n_ranks == r_new
    ev = tr.rescale_events[0]
    assert ev["repack_s"] >= 0.0 and ev["rebuild_s"] > 0.0
    assert ev["discarded_batches"] >= 0 and (prefetch or ev["discarded_batches"] == 0)
    tel = tr.telemetry
    assert isinstance(tel, MergedTelemetry) and tel.n_generations == 2
    assert [w.shape[1] for w in tel.work_matrices()] == [2, r_new]
    assert tel.rescale_seconds()[1] == ev["rebuild_s"]


def test_hierarchical_rescale_keeps_whole_nodes_or_says_it_goes_flat():
    tr = Trainer(PCFG, TrainerConfig(**TRAIN, n_ranks=4, n_nodes=2, compress_grads=True),
                 SyntheticCFMDataset(N_GRAPHS, seed=0, max_atoms=MAX_ATOMS), seed=0,
                 device="cpu")
    ev = tr.rescale(2)  # one node of 2 ranks: still hierarchical
    assert ev["n_nodes"] == 1 and tr.tcfg.n_nodes == 1
    assert isinstance(tr.sampler, HierarchicalBalancedSampler)
    assert {e.shape[0] for e in _leaves(tr.ef_state).values()} == {1}  # one per node
    with pytest.warns(RuntimeWarning, match="go flat"):
        ev = tr.rescale(3)
    assert ev["n_nodes"] is None and tr.tcfg.n_nodes is None
    assert type(tr.sampler) is BalancedBatchSampler and tr.engine.n_nodes is None
    assert {e.shape[0] for e in _leaves(tr.ef_state).values()} == {3}


# ---------------------------------------------------------------------------
# restart at another process count
# ---------------------------------------------------------------------------

CHILD = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.mace import MaceConfig
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.launch.multihost import initialize_distributed
from repro_torch.train.checkpoint import flatten_state
from repro_torch.train.train_loop import Trainer, TrainerConfig

cfg = json.loads(sys.argv[1])
out = sys.argv[2]
initialize_distributed(backend="gloo", timeout_s=120)
rank, world = dist.get_rank(), dist.get_world_size()
widths = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["widths"].items()}
tcfg = TrainerConfig(**cfg["train"], engine="data_parallel", n_ranks=world,
                     elastic=cfg["elastic"], ckpt_dir=cfg["ckpt"], ckpt_every=1)
tr = Trainer(MaceConfig(**widths, impl="cuda", interaction_impl="cuda"), tcfg,
             SyntheticCFMDataset(cfg["n_graphs"], seed=0, max_atoms=cfg["max_atoms"]),
             seed=0, device="cpu")
if world > 1:
    try:
        tr.rescale(1)
    except ValueError as exc:
        open(f"{out}/refusal.{rank}.txt", "w").write(str(exc))
resumed = tr.maybe_restore()
hist = tr.train(n_epochs=1, max_steps=cfg["steps"])["history"]  # the plan may end it
state = {k: v.numpy() for k, v in flatten_state(tr._state()).items()}
np.savez(f"{out}/final.{world}.{rank}.npz", **state)
with open(f"{out}/final.{world}.{rank}.json", "w") as f:
    json.dump({"losses": [h["loss"] for h in hist], "resumed": resumed,
               "start": tr.global_step - len(hist), "n_ranks": tr.engine.n_ranks,
               "lineage": tr._lineage}, f)
dist.destroy_process_group()
"""


def _spawn(n, cfg, out, env):
    res = spawn_local(n, [sys.executable, "-c", CHILD, json.dumps(cfg), str(out)],
                      env=dict(env, PYTHONPATH=str(REPO / "src")),
                      log_dir=str(out / f"logs{n}"))
    codes = res.wait(timeout=DEADLINE_S)
    logs = "".join(Path(p.log_path).read_text()[-3000:] for p in res.procs)
    return codes, logs


def test_two_process_run_restarts_as_one_process_and_equals_the_oracle(tmp_path):
    cfg = dict(widths=WIDTHS, n_graphs=48, max_atoms=MAX_ATOMS, steps=5,
               train=TRAIN, elastic=False, ckpt=str(tmp_path / "ckpt"))
    # both ranks die after step 3, before its checkpoint: step 2 is the newest
    codes, logs = _spawn(2, cfg, tmp_path, {
        "REPRO_FAULT_PLAN": json.dumps({"crash_at_step": {"step": 3}})})
    assert codes == [43, 43], logs
    refusal = (tmp_path / "refusal.0.txt").read_text()
    assert "'data_parallel' engine" in refusal and "restart at world size 1" in refusal
    assert "elastic=True" in refusal and "--supervised" in refusal
    step, meta = ckpt.read_meta(cfg["ckpt"])
    assert step == 3 - 1 and meta["process_count"] == 2 and meta["n_ranks"] == 2
    # without elastic the one-process restart refuses the 2-process checkpoint
    codes, logs = _spawn(1, cfg, tmp_path, {"REPRO_FAULT_PLAN": ""})
    assert codes != [0] and "written at n_ranks=2" in logs, logs
    codes, logs = _spawn(1, dict(cfg, elastic=True), tmp_path, {"REPRO_FAULT_PLAN": ""})
    assert codes == [0], logs
    info = json.loads((tmp_path / "final.1.0.json").read_text())
    assert info["resumed"] and info["start"] == 2 and info["n_ranks"] == 1
    assert info["lineage"] == [{"n_ranks": 2, "cursor": 2}]
    got = dict(np.load(tmp_path / "final.1.0.npz"))

    # the oracle: one sequential run on one thread, R = 2 rescaled to 1
    # after step 2
    oracle = ElasticTrainer(PCFG, TrainerConfig(**TRAIN, n_ranks=2),
                            SyntheticCFMDataset(48, seed=0, max_atoms=MAX_ATOMS),
                            rescale_schedule={2: 1}, seed=0, device="cpu")
    hist = oracle.train(n_epochs=1, max_steps=5)["history"]
    np.testing.assert_allclose(info["losses"], [h["loss"] for h in hist][2:], rtol=1e-5)
    want = {k: v.numpy() for k, v in ckpt.flatten_state(oracle._state()).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)
