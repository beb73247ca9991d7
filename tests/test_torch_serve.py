"""Port parity, serving: the port's request packing against the JAX
package's, a CPU ``GraphServer`` of the port (plain kernel versions) whose
served energies and forces match the JAX model per molecule with bridged
parameters, the worker-fault drill, and the rule that serving without
``device="cpu"`` needs a CUDA card.

Tolerance: rtol 1e-4, atol 1e-5 for served energies and forces, the
reference's own served-vs-direct bound (tests/test_serve.py).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mace import MaceConfig as JConfig
from repro.core.mace import init_mace as jinit
from repro.core.mace import mace_energy_forces as jforces
from repro.data.collate import collate_bin as jcollate
from repro.serve import bucket_ladder as jladder
from repro.serve import pack_requests as jpack
from repro_torch.bridge import params_from_jax
from repro_torch.core.mace import MaceConfig, init_mace
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.serve import (
    GraphServer,
    RequestTooLarge,
    ServeConfig,
    ServeEngine,
    bucket_key,
    bucket_ladder,
    pack_requests,
)

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=10.0)
TCFG = MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
# the reference model on its XLA impl, which the JAX tests hold equal to
# its Pallas kernels (tests/test_kernels.py::test_mace_model_pallas_impl_parity)
JCFG = JConfig(**WIDTHS, impl="fused", interaction_impl="fused")
CAPACITIES = (24, 48)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_requests_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 48, size=60)
    edges = sizes * rng.integers(2, 25, size=60)  # fits the 48-atom bucket alone
    got = pack_requests(sizes, edges, bucket_ladder(CAPACITIES, edge_factor=24))
    want = jpack(sizes, edges, jladder(CAPACITIES, edge_factor=24))
    assert [(idx, bucket_key(b)) for idx, b in got] == [
        (idx, f"n{b.max_nodes}_e{b.max_edges}_g{b.max_graphs}") for idx, b in want
    ]


def test_pack_requests_rejects_oversize_request():
    ladder = bucket_ladder([64], edge_factor=8)
    with pytest.raises(RequestTooLarge):
        pack_requests([65], [10], ladder)
    assert pack_requests([], [], ladder) == []


@pytest.fixture(scope="module")
def served():
    """One skewed-size load through a 2-bucket CPU server of the port, with
    parameters bridged from the JAX model."""
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), JCFG))
    ds = SyntheticCFMDataset(64, seed=3, max_atoms=max(CAPACITIES))
    server = GraphServer(
        TCFG, params_from_jax(jparams),
        ServeConfig(capacities=CAPACITIES, edge_factor=48, n_workers=2,
                    max_wait_s=0.01),
        device="cpu",
    )
    by_size = sorted(range(len(ds)), key=lambda i: int(ds.sizes[i]))
    picks = by_size[-3:] + by_size[:6] + by_size[-3:]  # hubs around small ones
    mols = [ds.get(i) for i in picks]
    futures = [server.submit(m, timeout=30.0) for m in mols]
    results = [f.result(timeout=300.0) for f in futures]
    stats = server.stats()
    yield dict(server=server, mols=mols, results=results, stats=stats,
               jparams=jparams)
    server.close()


def test_served_mix_resolves_every_request(served):
    stats = served["stats"]
    assert stats["served"] == len(served["mols"]) and stats["failed"] == 0
    assert any(r.n_copacked > 1 for r in served["results"])
    for m, r in zip(served["mols"], served["results"]):
        assert r.forces.shape == (m.n_atoms, 3)
        assert np.isfinite(r.energy) and np.isfinite(r.forces).all()


def test_served_energies_forces_match_jax(served):
    """Each request's energy and forces, routed back through pack -> collate
    -> the port's bucket forward -> future, against the JAX model on the
    molecule alone in the same bucket shape."""
    server = served["server"]
    fns = {}
    for mol, res in zip(served["mols"], served["results"]):
        bucket = next(b for b in server.buckets if bucket_key(b) == res.bucket)
        G = int(bucket.max_graphs)
        fn = fns.setdefault(G, jax.jit(lambda p, b, G=G: jforces(p, JCFG, b, G)))
        batch = {k: jnp.asarray(v) for k, v in jcollate([mol], bucket, strict=True).items()}
        e_ref, f_ref = fn(served["jparams"], batch)
        np.testing.assert_allclose(res.energy, float(e_ref[0]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res.forces, np.asarray(f_ref[: mol.n_atoms]),
                                   rtol=1e-4, atol=1e-5)


def test_worker_kill_drain_and_rebuild_drops_nothing():
    """Kill the only worker mid-load, heal synchronously, and require every
    request to resolve: the dying worker requeues its in-flight bin and the
    rebuild requeues anything stranded."""
    params = init_mace(TCFG, torch.Generator().manual_seed(0))
    ds = SyntheticCFMDataset(32, seed=5, max_atoms=24)
    server = GraphServer(
        TCFG, params,
        ServeConfig(capacities=(24,), edge_factor=48, n_workers=1,
                    max_wait_s=0.005, watchdog_s=0.0),  # heal by hand
        device="cpu",
    )
    try:
        mols = [ds.get(i) for i in range(12)]
        server.inject_worker_fault()
        futures = [server.submit(m, timeout=30.0) for m in mols]
        t0 = time.perf_counter()
        while all(w["alive"] for w in server.healthcheck()):
            assert time.perf_counter() - t0 < 60.0, "worker never died"
            time.sleep(0.01)
        assert server.check_and_heal(), "dead worker not detected"
        results = [f.result(timeout=300.0) for f in futures]
        assert len(results) == len(mols)
        assert all(np.isfinite(r.energy) for r in results)
        stats = server.stats()
        assert stats["failed"] == 0 and stats["served"] == len(mols)
        assert stats["rebuilds"] == 1
        assert server.check_and_heal() is False
    finally:
        server.close()


def test_serving_without_cpu_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    params = init_mace(TCFG, torch.Generator().manual_seed(0))
    ladder = bucket_ladder(CAPACITIES)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(TCFG, params, ladder)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(TCFG, params, ladder, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphServer(TCFG, params, ServeConfig(capacities=CAPACITIES))


def test_stats_carry_a_census_of_the_ladder_zero_on_the_cpu(served):
    """``stats()["compile_census"]`` is keyed by exactly the bucket ladder;
    the CPU engine serves eagerly and captures no graph."""
    server = served["server"]
    assert served["stats"]["compile_census"] == {
        bucket_key(b): 0 for b in server.buckets}
    assert server.engine.compile_census() == served["stats"]["compile_census"]


def _cpu_engine(cfg=TCFG):
    from repro_torch.serve import make_serve_engine

    params = init_mace(cfg, torch.Generator().manual_seed(0))
    return make_serve_engine(cfg, params, bucket_ladder(CAPACITIES), device="cpu")


@pytest.mark.parametrize("fault", ["shape", "dtype", "missing"])
def test_batch_outside_the_bucket_raises_and_is_not_served(fault):
    """A batch whose arrays differ from the bucket's buffers raises a
    ``ValueError`` naming the bucket and the array, before anything is
    copied: the buffers keep what they held, and nothing is recaptured."""
    engine = _cpu_engine()
    small, large = engine.buckets
    mols = [SyntheticCFMDataset(8, seed=0, max_atoms=12).get(0)]
    batch, _ = engine.collate(mols, small)
    held = {k: v.clone() for k, v in engine._program(small).inputs.items()}
    if fault == "shape":
        bucket, name = large, "species"
    elif fault == "dtype":
        bucket, name = small, "positions"
        batch["positions"] = batch["positions"].double()
    else:
        bucket, name = small, "graph_id"
        del batch["graph_id"]
    with pytest.raises(ValueError, match=f"bucket {bucket_key(bucket)}.*{name}"):
        engine.forward(batch, bucket)
    for k, v in engine._program(small).inputs.items():
        assert torch.equal(v, held[k]), k
    assert engine.compile_census() == {bucket_key(b): 0 for b in engine.buckets}
    engine.close()


@pytest.mark.parametrize("impl", ["cuda", "fused", "ref"])
def test_warm_forward_builds_no_tensor_from_the_host(impl, monkeypatch):
    """After a warm forward, a second forward of each impl makes no
    ``torch.as_tensor`` / ``torch.tensor`` call on host data: on the card
    each would be a copy from the host, which a CUDA graph cannot
    capture."""
    cfg = MaceConfig(**WIDTHS, impl=impl, interaction_impl=impl)
    engine = _cpu_engine(cfg)
    bucket = engine.buckets[-1]
    ds = SyntheticCFMDataset(8, seed=0, max_atoms=24)
    batch, _ = engine.collate([ds.get(0), ds.get(1)], bucket)

    def refuse(name, real):
        def guarded(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name} on {type(data).__name__} "
                                     "inside a warm forward")
            return real(data, *args, **kwargs)
        return guarded

    # one intra-op thread: under CPU contention a sum split over threads can
    # differ between two calls, and the two forwards are held bit for bit
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = [t.clone() for t in engine.forward(batch, bucket)]
        monkeypatch.setattr(torch, "as_tensor", refuse("as_tensor", torch.as_tensor))
        monkeypatch.setattr(torch, "tensor", refuse("tensor", torch.tensor))
        got = engine.forward(batch, bucket)
        monkeypatch.undo()
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    engine.close()


def test_fault_plan_env_kills_one_worker_and_the_fleet_rebuilds(monkeypatch):
    """``REPRO_FAULT_PLAN={"serve_worker_fault": {}}``: the first bin a worker
    takes raises, that worker dies and requeues it, the heal rebuilds the
    fleet, and every request resolves."""
    monkeypatch.setenv("REPRO_FAULT_PLAN", '{"serve_worker_fault": {}}')
    params = init_mace(TCFG, torch.Generator().manual_seed(0))
    ds = SyntheticCFMDataset(32, seed=5, max_atoms=24)
    server = GraphServer(
        TCFG, params,
        ServeConfig(capacities=(24,), edge_factor=48, n_workers=2,
                    max_wait_s=0.005, watchdog_s=0.0),  # heal by hand
        device="cpu",
    )
    try:
        mols = [ds.get(i) for i in range(12)]
        futures = [server.submit(m, timeout=30.0) for m in mols]
        t0 = time.perf_counter()
        while all(w["alive"] for w in server.healthcheck()):
            assert time.perf_counter() - t0 < 60.0, "no worker died"
            time.sleep(0.01)
        dead = [w for w in server.healthcheck() if not w["alive"]]
        assert len(dead) == 1 and "REPRO_FAULT_PLAN" in dead[0]["error"]
        assert server.check_and_heal()
        results = [f.result(timeout=300.0) for f in futures]
        assert len(results) == len(mols)
        stats = server.stats()
        assert stats["failed"] == 0 and stats["served"] == len(mols)
        assert stats["rebuilds"] == 1
        assert all(w["alive"] for w in server.healthcheck())
    finally:
        server.close()
