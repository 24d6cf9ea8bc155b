"""The PyTorch port's package boundary: no jax, no repro; the copied config,
data generator, transport, comm log and sharding helpers agree with the
originals, and so do the mesh's strategy and wire-byte functions; FedSim
refuses bad scale-out knobs as the JAX FedSim does; missing CUDA raises
instead of falling back."""
import dataclasses
import itertools
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.comm import metrics as jmetrics
from repro.comm import transport as jtransport
from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import FederatedClassification as JaxData
from repro_torch.comm import metrics as tmetrics
from repro_torch.comm import transport as ttransport
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.data.synthetic import FederatedClassification

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODULES = [
    "repro_torch", "repro_torch.configs.base", "repro_torch.data.synthetic",
    "repro_torch.models.params", "repro_torch.models.convmixer",
    "repro_torch.core.compressors", "repro_torch.core.server_opt",
    "repro_torch.core.local", "repro_torch.core.sampling",
    "repro_torch.core.stages", "repro_torch.core.sim",
    "repro_torch.core.error_feedback", "repro_torch.comm.wire",
    "repro_torch.comm.transport", "repro_torch.comm.metrics",
    "repro_torch.kernels.ref", "repro_torch.kernels._build",
    "repro_torch.kernels.ops", "repro_torch.convert",
    "repro_torch.comm.faults", "repro_torch.comm", "repro_torch.configs",
    "repro_torch.checkpoint", "repro_torch.checkpoint.store",
    "repro_torch.core", "repro_torch.core.api", "repro_torch.core.rounds",
    "repro_torch.comm.async_engine", "repro_torch.core.mesh",
    "repro_torch.sharding", "repro_torch.sharding.rules",
    "repro_torch.launch", "repro_torch.launch.mesh",
    "repro_torch.configs.registry", "repro_torch.data",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.moe",
    "repro_torch.models.stack", "repro_torch.models.xlstm",
    "repro_torch.models.model", "repro_torch.launch.serve",
    "repro_torch.launch.train",
]


def test_import_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from repro_torch.configs import all_archs\n"
            "all_archs()\n"
            "import repro_torch.core as c\n"
            "for name in c.__all__: getattr(c, name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_scripts_load_no_jax_and_no_repro():
    """chip_smoke.py and the scripts that time the port on the card run
    where there is no jax: importing them loads neither jax nor repro."""
    root = os.path.join(os.path.dirname(__file__), "..")
    scripts = ["chip_smoke", "ingest_floor", "pack_floor", "sign_floor",
               "topk_floor", "profile_round"]
    code = ("import importlib, sys\n"
            f"for m in {scripts!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, root, os.path.join(root, "scripts")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


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


def test_trainconfig_fields_and_defaults_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(JaxTrainConfig)]
    assert ours == theirs


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


@pytest.mark.parametrize("kw", [
    dict(client_chunk=3, participating=4),
    dict(client_chunk=3, participating=8, compressor="sign"),
    dict(agg_groups=2, participating=4, sparse_uplink=False,
         compressor="blocktopk"),
    dict(agg_groups=2, participating=8, client_chunk=2),
    dict(agg_groups=4, participating=8, client_chunk=4),
], ids=["chunk-not-dividing", "chunk-not-dividing-dense",
        "groups-dense-path", "chunk-not-group-size", "chunk-not-group-size-4"])
def test_fedsim_refuses_bad_scale_out_knobs_as_jax_does(kw):
    """FedConfig accepts these; FedSim's constructor refuses each with the
    JAX FedSim's ValueError, message for message."""
    from repro.core.sim import FedSim as JaxSim
    from repro_torch.core.sim import FedSim
    kw = dict(num_clients=8, **kw)
    with pytest.raises(ValueError) as jax_err:
        JaxSim(lambda p, b: None, JaxFedConfig(**kw))
    with pytest.raises(ValueError) as port_err:
        FedSim(lambda p, b: None, FedConfig(**kw), device="cpu")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kw", [
    dict(ef_store=True),
    dict(client_chunk=2, participating=4, agg_groups=2),
    dict(wire=True, async_buffer=2, participating=4, track_gamma=False,
         compressor="blocktopk"),
    dict(compressor="randk"),
])
def test_fedsim_accepts_the_knobs_the_jax_fedsim_accepts(kw):
    from repro_torch.core.sim import FedSim
    FedSim(lambda p, b: None, FedConfig(num_clients=8, **kw), device="cpu")


def test_fedsim_wire_needs_a_codec_and_wire_mode_for_a_network():
    from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
    from repro_torch.core.sim import FedSim
    with pytest.raises(ValueError, match="no wire codec"):
        FedSim(lambda p, b: None, FedConfig(compressor="int8", wire=True),
               device="cpu")
    with pytest.raises(ValueError, match="wire is False"):
        FedSim(lambda p, b: None, FedConfig(),
               network=SimulatedNetwork(NetworkConfig(), 4), device="cpu")


@pytest.mark.parametrize("cfg", [
    dict(), dict(straggler_prob=0.5, latency_jitter_ms=30.0, seed=7,
                 compute_s=0.25)])
def test_transport_copy_draws_what_the_original_draws(cfg):
    """The same per-client links, per-round latency/straggler draws and
    timing reports, bit for bit, over resampled and reordered cohorts."""
    jnet = jtransport.SimulatedNetwork(jtransport.NetworkConfig(**cfg), 50)
    tnet = ttransport.SimulatedNetwork(ttransport.NetworkConfig(**cfg), 50)
    r = np.random.default_rng(0)
    for rnd in range(6):
        ids = r.choice(50, size=int(r.integers(0, 12)), replace=False)
        a = jnet.round(ids, 1000 + rnd, 90000, rnd)
        b = tnet.round(ids, 1000 + rnd, 90000, rnd)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb and type(va) is type(vb), f.name
    ids = np.arange(1000, 1010)
    for lane in (0, 2, 5):
        np.testing.assert_array_equal(
            jtransport.client_round_u01(3, 9, ids, lane),
            ttransport.client_round_u01(3, 9, ids, lane))
    assert dataclasses.asdict(jtransport.NetworkConfig()) == \
        dataclasses.asdict(ttransport.NetworkConfig())


def test_event_clock_and_commlog_copies_book_what_the_originals_book():
    jc, tc = jtransport.EventClock(), ttransport.EventClock()
    for t, p in ((2.0, "a"), (1.0, "b"), (2.0, "c"), (0.5, "d")):
        jc.push(t, p)
        tc.push(t, p)
    assert [jc.pop() for _ in range(4)] == [tc.pop() for _ in range(4)]
    assert jc.now == tc.now and len(tc) == 0
    jnet = jtransport.SimulatedNetwork(jtransport.NetworkConfig(), 20)
    jlog, tlog = jmetrics.CommLog(), tmetrics.CommLog()
    for rnd, kw in enumerate([dict(), dict(tier2_bytes=4096),
                              dict(round_time_s=0.125,
                                   delivered_uplink_bytes=300)]):
        timing = jnet.round(np.arange(5) + rnd, 500, 2000, rnd)
        tt = ttransport.RoundTiming(**dataclasses.asdict(timing))
        assert jlog.record(timing, **kw) == tlog.record(tt, **kw)
    assert dataclasses.asdict(jlog) == dataclasses.asdict(tlog)
    assert jlog.total_bytes == tlog.total_bytes


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    from repro_torch import resolve_device
    from repro_torch.core import mesh as meshmod
    from repro_torch.core.sim import FedSim
    from repro_torch.kernels.ops import KernelImpl
    from repro_torch.sharding.rules import ParallelContext
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        FedSim(lambda p, b: None, FedConfig())
    from repro_torch.core.api import FederatedTrainer
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedTrainer(fed=FedConfig(), loss_fn=lambda p, b: None,
                         init_params={"w": torch.zeros(3)})
    model = SimpleNamespace(defs=lambda: {})
    with pytest.raises(RuntimeError, match="CUDA"):
        meshmod.init_fed_state(model, FedConfig(), torch.Generator(),
                               ParallelContext())
    with pytest.raises(RuntimeError, match="CUDA"):
        meshmod.shard_batch({}, model, FedConfig(), TrainConfig(),
                            ParallelContext())
    assert KernelImpl().compiled and not KernelImpl(device="cpu").compiled
    assert resolve_device("cpu") == torch.device("cpu")


def test_zoo_entry_points_need_cuda_unless_cpu_is_asked_for():
    """``Model.init``/``init_cache``, ``convert.model_params_from_jax``,
    the serve and train bodies (and so every consumer of
    ``FederatedLMData`` on the mesh) default to CUDA and raise without a
    card; each runs on ``device="cpu"``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import Model
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is available")
    cfg = get_arch("gemma2-2b").smoke
    m = Model(cfg)
    for call in (lambda: m.init(torch.Generator()),
                 lambda: m.init_cache(1, 8),
                 lambda: model_params_from_jax({"w": np.zeros(2)}),
                 lambda: tserve.serve(cfg, batch=1, prompt_len=4, gen=2),
                 lambda: ttrain.train(cfg, FedConfig(), TrainConfig()),
                 lambda: ttrain.launch(cfg, FedConfig(), TrainConfig(),
                                       dp=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert m.init(torch.Generator(), "cpu")["final_norm"].device.type == "cpu"
    assert m.init_cache(1, 8, device="cpu")["groups"]["l0"]["k"].shape == (
        1, 1, 8, 2, 32)


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
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.topk_ef_cuda(x, err, rows, k=4, block=128)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.sign_ef_cuda(x, err, rows)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.pack_uint_cuda(torch.zeros(9, dtype=torch.uint8), 1)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.unpack_uint_cuda(torch.zeros(9, dtype=torch.uint8), 1, 70)
    assert all(n == 0 for n in ops.launches.values())


def test_sharding_copies_match_the_originals():
    """``pad_to``, ``padded_vocab`` and ``attn_dims`` (pure Python) are
    copies: the same values over a grid of head counts and tp."""
    from repro.sharding import rules as jr
    from repro_torch.sharding import rules as tr
    for n, mult in itertools.product(range(0, 40), (0, 1, 2, 3, 8)):
        assert tr.pad_to(n, mult) == jr.pad_to(n, mult)
        assert tr.padded_vocab(n, mult) == jr.padded_vocab(n, mult)
    for h, kv, tp in itertools.product((1, 2, 3, 8, 12, 14), (1, 2, 4, 7),
                                       (1, 2, 4, 8)):
        if kv > h:
            continue
        assert (dataclasses.asdict(tr.attn_dims(h, kv, 64, tp))
                == dataclasses.asdict(jr.attn_dims(h, kv, 64, tp)))


MESH_CFGS = [
    dict(),
    dict(algorithm="fedcams", compressor="blocktopk", aggregation="sparse"),
    dict(algorithm="fedcams", compressor="topk", aggregation="sparse",
         compress_ratio=0.01),
    dict(algorithm="fedcams", compressor="blocktopk", aggregation="sparse",
         agg_groups=2, client_axes=("cgroup", "data")),
    dict(algorithm="fedcams", compressor="packedsign", aggregation="sparse"),
    dict(algorithm="fedcams", compressor="sign", aggregation="sparse"),
    dict(algorithm="fedcams", compressor="blocktopk", delta_dtype="bfloat16"),
    dict(algorithm="fedams", aggregation="sparse"),
]


@pytest.mark.parametrize("kw", MESH_CFGS)
def test_mesh_strategy_and_wire_bytes_match_the_originals(kw):
    """``mesh_agg_strategy``, ``leaf_wire_bytes``, ``leaf_tier2_bytes`` and
    ``mesh_wire_bytes_tiers`` (what the round bills as ``wire_up_bytes``)
    give the JAX package's values, leaf sizes with ragged blocks
    included, and ``mesh_metric_specs`` names the same metrics."""
    from repro.core import mesh as jm
    from repro.core import stages as js
    from repro_torch.core import mesh as tm
    from repro_torch.core import stages as ts
    jf, tf_ = JaxFedConfig(**kw), FedConfig(**kw)
    assert ts.mesh_agg_strategy(tf_) == js.mesh_agg_strategy(jf)
    for dl in (1, 7, 100, 300, 2048, 2176, 4097, 704266):
        assert tm.leaf_wire_bytes(tf_, dl) == jm.leaf_wire_bytes(jf, dl)
        assert tm.leaf_tier2_bytes(tf_, dl) == jm.leaf_tier2_bytes(jf, dl)
    tree = {"w": np.zeros(2176, np.float32), "b": np.zeros((3, 100))}
    for tp in (1, 2):
        assert (tm.mesh_wire_bytes_tiers(tf_, tree, tp=tp)
                == jm.mesh_wire_bytes_tiers(jf, tree, tp=tp))
    if not kw:    # the fault metrics' keys, once
        from repro.comm.faults import FaultConfig as JaxFaultConfig
        from repro_torch.comm.faults import FaultConfig as PortFaultConfig
        jf = JaxFedConfig(track_gamma=False,
                          fault=JaxFaultConfig(crash_prob=0.1))
        tf_ = FedConfig(track_gamma=False,
                        fault=PortFaultConfig(crash_prob=0.1))
    for scan in (False, True):
        assert (set(tm.mesh_metric_specs(tf_, scan=scan))
                == set(jm.mesh_metric_specs(jf, scan=scan)))


def test_participation_masks_are_shared_draws():
    """n of m ones (all ones at n in {0, m}); the same generator seed gives
    the same mask, as every rank must draw; weighted sampling never picks
    a zero-weight client."""
    from repro_torch.core.sampling import (participation_mask,
                                           round_generator,
                                           weighted_participation_mask)
    for seed in range(5):
        a = participation_mask(round_generator(seed, 1), 10, 4)
        b = participation_mask(round_generator(seed, 1), 10, 4)
        assert torch.equal(a, b) and a.sum() == 4
        assert set(a.tolist()) <= {0.0, 1.0}
        w = torch.tensor([0.0, 1.0, 2.0, 0.0, 3.0, 1.0])
        wm = weighted_participation_mask(round_generator(seed, 3), w, 3)
        assert wm.sum() == 3 and wm[w == 0].sum() == 0
    assert torch.equal(participation_mask(round_generator(0), 6, 0),
                       torch.ones(6))
    assert not torch.equal(participation_mask(round_generator(0, 1), 50, 9),
                           participation_mask(round_generator(1, 1), 50, 9))
