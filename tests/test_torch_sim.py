"""The whole FedSim round: the port against the JAX FedSim on staged
inputs — client ids drawn on the JAX side, the same numpy batches, and the
JAX init converted. Trajectories are held to a tolerance (XLA and PyTorch
sum the local gradients in different orders, and XLA:CPU contracts the
jitted server step into FMAs). tests/test_torch_sim_stages.py holds the
bitwise round-0 EF check and the other configurations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core.sampling import sample_clients as jax_sample
from repro.core.sim import FedSim as JaxSim
from repro.models import params as jp
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.sim import FedSim
from repro_torch.models import convmixer as tcm

torch.set_num_threads(1)

M, N, K, B = 20, 4, 2, 8
LOSS_RTOL = 1e-3     # per-round loss, relative


def _port_loss(model):
    if model == "convmixer":   # benchmarks.common.make_problem's ConvMixer
        c = tcm.ConvMixerConfig(dim=32, depth=4, kernel=5, patch=2,
                                num_classes=10, image=16)
        return lambda p, b: tcm.convmixer_loss(p, b, c)
    c = tcm.MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
    return lambda p, b: tcm.mlp_loss(p, b, c)


def _cfg(route, **extra):
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=K, num_clients=M, participating=N,
              compressor="blocktopk")
    if route == "a":       # fused one-pass ingest through the kernel path
        kw.update(track_gamma=False, fused_ingest="kernel")
    kw.update(extra)
    return kw


def _staged_rounds(data, rounds, seed=1):
    rng = jax.random.PRNGKey(seed)
    out = []
    for r in range(rounds):
        rng, k1, k2 = jax.random.split(rng, 3)
        idx = np.array(jax_sample(k1, M, N))
        out.append((idx, data.round_batches(idx, r, K, B), k2))
    return out


def _run_both(model, kw, rounds):
    defs, jloss, data = make_problem(model, M)
    p0 = jp.init_params(defs, jax.random.PRNGKey(0))
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss(model), FedConfig(**kw), device="cpu")
    jstate = js.init(p0)
    tstate = ts.init(params_from_jax(jax.device_get(p0)))
    hist = []
    for idx, b, key in _staged_rounds(data, rounds):
        jstate, jm = js.round(jstate, jax.tree.map(jnp.asarray, b),
                              jnp.asarray(idx), key)
        tstate, tm = ts.round(tstate, b, idx)
        hist.append((float(jm["loss"]), float(tm["loss"]),
                     float(jm["gamma"]), float(tm["gamma"])))
        assert tm["bits"] == jm["bits"]
    jflat = np.asarray(jax.flatten_util.ravel_pytree(jstate.params)[0])
    return np.array(hist), jflat, tstate, ts


@pytest.mark.parametrize("model", ["mlp", "convmixer"])
@pytest.mark.parametrize("route", ["a", "b"])
def test_fedsim_tracks_jax_fedsim(model, route):
    """Route (a): track_gamma=False, fused ingest forced to the kernel path
    (the twin here, the Pallas interpreter on the JAX side). Route (b): the
    default track_gamma=True two-pass round (scatter-mean +
    ``server_update``). 10 rounds; per-round loss within 1e-3 relative."""
    hist, jflat, tstate, ts = _run_both(model, _cfg(route), rounds=10)
    assert ts._fused == ("kernel" if route == "a" else "off")
    np.testing.assert_allclose(hist[:, 1], hist[:, 0], rtol=LOSS_RTOL)
    if route == "b":
        np.testing.assert_allclose(hist[:, 3], hist[:, 2], rtol=1e-3)
        assert (hist[:, 3] > 0).all()
    else:
        assert (hist[:, 3] == 0).all()
    np.testing.assert_allclose(tstate.params.numpy(), jflat, atol=1e-4)
    assert tstate.round == 10 and int(tstate.opt.t) == 10
