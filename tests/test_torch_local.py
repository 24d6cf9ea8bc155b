"""Local-update rules, the local LR schedule and client sampling: the port
against ``repro.core.local`` on the same converted params and batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import local as jl
from repro.models import convmixer as jcm
from repro.models import params as jp
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import local as tl
from repro_torch.core.sampling import sample_clients
from repro_torch.models import convmixer as tcm
from repro_torch.models.params import ravel

torch.set_num_threads(1)

MLP = dict(in_dim=16, hidden=24, depth=2, num_classes=10)


def _problem(K=4):
    jc, tc = jcm.MLPConfig(**MLP), tcm.MLPConfig(**MLP)
    p = jp.init_params(jcm.mlp_defs(jc), jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    b = {"x": r.normal(size=(K, 8, 16)).astype(np.float32),
         "y": r.integers(0, 10, size=(K, 8)).astype(np.int32)}
    return jc, tc, p, b


@pytest.mark.parametrize("local_opt", ["sgd", "sgdm", "prox"])
@pytest.mark.parametrize("k_i", [None, 2, 0])
def test_run_local_steps_matches_jax(local_opt, k_i):
    jc, tc, p, b = _problem()
    kw = dict(local_opt=local_opt, prox_mu=0.1, local_momentum=0.8)
    jrule = jl.make_local_update(JaxFedConfig(**kw))
    trule = tl.make_local_update(FedConfig(**kw))

    def jgrad(pp, bb):
        (loss, _), g = jax.value_and_grad(
            lambda q: jcm.mlp_loss(q, bb, jc), has_aux=True)(pp)
        return loss, g

    flat, unravel = ravel(params_from_jax(jax.device_get(p)))

    def tgrad(pp, bb):
        pp = pp.detach().requires_grad_(True)
        loss, _ = tcm.mlp_loss(unravel(pp), bb, tc)
        (g,) = torch.autograd.grad(loss, pp)
        return loss.detach(), g

    jk = None if k_i is None else jnp.int32(k_i)
    jlocal, jloss = jl.run_local_steps(jrule, jgrad, p,
                                       jax.tree.map(jnp.asarray, b), 0.1,
                                       k_i=jk)
    tlocal, tloss = tl.run_local_steps(
        trule, tgrad, flat, {k: torch.from_numpy(v) for k, v in b.items()},
        0.1, k_i=k_i)
    np.testing.assert_allclose(tlocal.numpy(),
                               np.asarray(ravel_pytree(jlocal)[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-7)
    if k_i == 0:
        assert torch.equal(tlocal, flat)


@pytest.mark.parametrize("decay,t", [(1.0, 7), (0.9, 0), (0.95, 13)])
def test_local_lr_matches_jax(decay, t):
    want = jl.local_lr(JaxFedConfig(eta_l=0.05, eta_l_decay=decay), t)
    got = tl.local_lr(FedConfig(eta_l=0.05, eta_l_decay=decay), t)
    assert np.float32(got) == np.float32(want)


def test_hetero_step_counts_range_and_off_switch():
    assert tl.hetero_step_counts(FedConfig(), None, 5) is None
    fed = FedConfig(local_steps=4, local_steps_min=2)
    k = tl.hetero_step_counts(fed, torch.Generator().manual_seed(0), 500)
    assert k.shape == (500,) and int(k.min()) == 2 and int(k.max()) == 4
    with pytest.raises(ValueError, match="Generator"):
        tl.hetero_step_counts(fed, None, 3)


def test_sample_clients_without_replacement():
    g = torch.Generator().manual_seed(0)
    idx = sample_clients(g, 100, 10)
    assert idx.dtype == torch.int64 and idx.numel() == 10
    assert len(set(idx.tolist())) == 10 and int(idx.max()) < 100
    assert torch.equal(sample_clients(g, 8, 0), torch.arange(8))
    # the empirical inclusion rate is n/m
    hits = torch.zeros(20)
    g = torch.Generator().manual_seed(2)
    for _ in range(2000):
        hits[sample_clients(g, 20, 5)] += 1
    assert float((hits / 2000 - 0.25).abs().max()) < 0.05
