"""Port parity, the training step against the JAX step under its remat.

The JAX ``TrainerConfig.remat`` checkpoints the loss (``jax.checkpoint``);
the port has no such knob (ROADMAP queue C: with forces in the loss,
``torch.utils.checkpoint`` keeps what it recomputes and saves no memory).
So the port's step must equal the JAX step with ``remat`` off and on: the
loss, its metrics and the parameter gradients on one bin of the
``Trainer``, from bridged JAX parameters, on the CPU.  The JAX side runs
the ``fused`` impls (its plain reference of the Pallas kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.mace import MaceConfig as JConfig
from repro.core.mace import init_mace as jinit
from repro.train.engine import make_loss_fn as jmake_loss_fn
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.core.mace import MaceConfig
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.train.train_loop import Trainer, TrainerConfig

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
PCFG = MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
JCFG = JConfig(**WIDTHS, impl="fused", interaction_impl="fused")
TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8, block_n=8, block_e=32)
N_GRAPHS, MAX_ATOMS = 24, 24


@pytest.mark.parametrize("remat", [False, True])
def test_the_step_equals_the_jax_step_with_and_without_its_remat(remat):
    """The port has no remat (ROADMAP queue C): its step's loss and
    gradients on the first bin equal the JAX step's under
    ``TrainerConfig.remat`` off and on, at the bounds of
    tests/test_torch_second_order.py::test_weighted_loss_and_param_grads_match_jax
    (metrics rtol 2e-5; gradients rtol 2e-4 / atol 2e-4)."""
    jparams = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(5), JCFG))
    tr = Trainer(PCFG, TrainerConfig(**TRAIN), SyntheticCFMDataset(N_GRAPHS, seed=0,
                 max_atoms=MAX_ATOMS), seed=0, device="cpu", params=params_from_jax(jparams))
    host, _ = tr._fetch_batch(next(tr.sampler.step_iter(tr.sampler_state)))
    grads, metrics = tr.engine.grads(tr.params, tr.engine.to_device(host)[0])
    jloss = jmake_loss_fn(JCFG, JTrainerConfig(**TRAIN, remat=remat), TRAIN["max_graphs"])
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in host[0].items()})
    for k in ("loss", "e_rmse", "f_rmse"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-5, err_msg=k)
    want = flatten(params_from_jax(jax.tree.map(np.asarray, jgrads)))
    assert want.keys() == grads.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    assert max(float(g.abs().max()) for g in want.values()) > 0
