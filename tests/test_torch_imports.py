"""The PyTorch port's package boundary: no jax, no repro; the copied config
and data generator agree with the originals; unported knobs and missing
CUDA raise instead of falling back."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JaxFedConfig
from repro.data.synthetic import FederatedClassification as JaxData
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import FederatedClassification

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODULES = [
    "repro_torch", "repro_torch.configs.base", "repro_torch.data.synthetic",
    "repro_torch.models.params", "repro_torch.models.convmixer",
    "repro_torch.core.compressors", "repro_torch.core.server_opt",
    "repro_torch.core.local", "repro_torch.core.sampling",
    "repro_torch.core.stages", "repro_torch.core.sim",
    "repro_torch.kernels.ref", "repro_torch.kernels._build",
    "repro_torch.kernels.ops", "repro_torch.convert",
]


def test_import_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_fedconfig_fields_and_defaults_match():
    ours = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxFedConfig)}
    assert list(ours) == list(theirs)
    assert ours == theirs


@pytest.mark.parametrize("kw", [
    dict(algorithm="adam"), dict(option=3), dict(compressor="topq"),
    dict(fused_ingest="fast"), dict(server_state_dtype="int4"),
    dict(server_state_dtype="int8", algorithm="fedadam"),
    dict(local_opt="lbfgs"), dict(sparse_uplink=True, compressor="sign"),
    dict(eta_l_decay=0.0), dict(local_steps_min=9, local_steps=4),
    dict(agg_groups=0), dict(agg_groups=3, participating=10,
                             compressor="topk"),
    dict(deadline_s=1.0), dict(deadline_s=1.0, wire=True),
    dict(async_buffer=2), dict(async_buffer=2, wire=True, track_gamma=False,
                               two_way=True, participating=4),
])
def test_fedconfig_validation_matches(kw):
    with pytest.raises(ValueError) as jax_err:
        JaxFedConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        FedConfig(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_fedconfig_refuses_fault_plans():
    with pytest.raises(NotImplementedError, match="fault"):
        FedConfig(fault=object())


@pytest.mark.parametrize("kw", [dict(feature_dim=32, alpha=0.3),
                                dict(image_shape=(8, 8, 3), alpha=1.0,
                                     seed=3)])
def test_federated_classification_draws_the_same_batches(kw):
    a, b = JaxData(num_clients=12, **kw), FederatedClassification(
        num_clients=12, **kw)
    np.testing.assert_array_equal(a.prototypes, b.prototypes)
    np.testing.assert_array_equal(a.label_dist, b.label_dist)
    for r in range(3):
        ja = a.round_batches([0, 5, 11], r, 2, 6)
        pb = b.round_batches([0, 5, 11], r, 2, 6)
        for key in ("x", "y"):
            assert ja[key].dtype == pb[key].dtype
            np.testing.assert_array_equal(ja[key], pb[key])


@pytest.mark.parametrize("knob,kw", [
    ("wire", dict(wire=True)),
    ("deadline_s", dict(wire=True, deadline_s=1.0, track_gamma=False)),
    ("async_buffer", dict(wire=True, async_buffer=2, participating=4,
                          track_gamma=False, compressor="blocktopk")),
    ("ef_store", dict(ef_store=True)),
    ("client_chunk", dict(client_chunk=2, participating=4)),
    ("agg_groups", dict(agg_groups=2, participating=4)),
    ("two_way", dict(two_way=True)),
    ("sparse_uplink", dict(sparse_uplink=False)),
])
def test_fedsim_refuses_unported_knobs_by_name(knob, kw):
    from repro_torch.core.sim import FedSim
    fed = FedConfig(num_clients=8, **kw)
    with pytest.raises(NotImplementedError, match=knob):
        FedSim(lambda p, b: None, fed, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    from repro_torch import resolve_device
    from repro_torch.core.sim import FedSim
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        FedSim(lambda p, b: None, FedConfig())
    assert resolve_device("cpu") == torch.device("cpu")


def test_forced_kernels_raise_on_cpu_tensors():
    """The kernel wrappers never run their twins: a CPU tensor is refused
    before anything is built or launched."""
    from repro_torch.kernels import ops
    x = torch.zeros(2, 256)
    err = torch.zeros(4, 256)
    rows = torch.tensor([0, 1])
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.topk_ef_sparse_cuda(x, err, rows, k=4, block=128)
    v = torch.zeros(256)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.fedams_update_cuda(v, v, v, v, v, eta=0.1, beta1=0.9,
                               beta2=0.99, eps=1e-3)
    vals = torch.zeros(2, 2, 4)
    idx = torch.zeros(2, 2, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.fedams_ingest_cuda(v, v, v, v, vals, idx, n_div=2, eta=0.1,
                               beta1=0.9, beta2=0.99, eps=1e-3, block=128)
    assert all(n == 0 for n in ops.launches.values())
