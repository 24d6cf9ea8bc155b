"""FedSim's local phase on the card: the batched block (one
``torch.func.vmap`` program over the clients, ``FedSim._train_block``)
against its plain twin ``core.local.train_clients_loop`` on make_problem's
two models (``benchmarks/common.py``'s ConvMixer and MLP, rebuilt from the
port's modules), route a's round-0 block: n = 10 clients, K = 3 steps,
batch 20, under deterministic algorithms, within ``chip_smoke.py``'s
``BLOCK_TOL``. Marked ``cuda``: the ``card`` fixture skips without CUDA.
No jax here, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_local_block_cuda.py
"""
import os

# cuBLAS needs this before CUDA starts for deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.local import (autograd_grad_fn,  # noqa: E402
                                    train_clients_loop)
from repro_torch.core.sim import FedSim  # noqa: E402
from repro_torch.data.synthetic import FederatedClassification  # noqa: E402
from repro_torch.models import convmixer as cm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

pytestmark = pytest.mark.cuda

M, N, K, B = 100, 10, 3, 20
#: chip_smoke.py's BLOCK_TOL: batched against the loop, absolute
BLOCK_TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _problem(model):
    if model == "convmixer":
        c = cm.ConvMixerConfig(dim=32, depth=4, kernel=5, patch=2,
                               num_classes=10, image=16)
        data = FederatedClassification(num_clients=M, image_shape=(16, 16, 3),
                                       alpha=0.3, seed=0)
        return (cm.convmixer_defs(c),
                lambda p, b: cm.convmixer_loss(p, b, c), data)
    c = cm.MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
    data = FederatedClassification(num_clients=M, feature_dim=32, alpha=0.3,
                                   seed=0)
    return cm.mlp_defs(c), lambda p, b: cm.mlp_loss(p, b, c), data


@pytest.mark.parametrize("hetero", [False, True], ids=["K", "K_i"])
@pytest.mark.parametrize("model", ["convmixer", "mlp"])
def test_batched_block_is_the_loop_on_the_card(card, model, hetero):
    """Deltas (c, d) and losses (c,) of the batched block within
    ``BLOCK_TOL`` of the loop's, finite, with all n step counts or with
    heterogeneous ones (1..K, handed to both)."""
    defs, loss, data = _problem(model)
    fed = FedConfig(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
                    local_steps=K, num_clients=M, participating=N,
                    compressor="blocktopk", compress_ratio=1 / 64,
                    track_gamma=False, local_steps_min=1 if hetero else 0)
    sim = FedSim(loss, fed)
    flat0 = sim.init(init_params(defs,
                                 torch.Generator().manual_seed(0))).x_client
    ids = np.random.default_rng(1).choice(M, N, replace=False)
    batches = {k: torch.as_tensor(v, device=card)
               for k, v in data.round_batches(ids, 0, K, B).items()}
    k_blk = (torch.as_tensor(np.random.default_rng(2).integers(1, K + 1, N),
                             device=card) if hetero else None)
    eta_l = torch.tensor(0.05, device=card)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        delta, losses = sim._train_block(flat0, batches, eta_l, k_blk)
        ldelta, llosses = train_clients_loop(
            sim.rule, autograd_grad_fn(sim.loss_fn, sim.unravel), flat0,
            batches, eta_l, k_blk)
    finally:
        torch.use_deterministic_algorithms(False)
    assert delta.shape == (N, flat0.numel()) and losses.shape == (N,)
    assert bool(torch.isfinite(delta).all())
    assert float((delta - ldelta).abs().max()) <= BLOCK_TOL
    assert float((losses - llosses).abs().max()) <= BLOCK_TOL * float(
        llosses.abs().max())
