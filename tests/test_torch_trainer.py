"""``FederatedTrainer`` (the simulation backend) in the port: its history
equals a loop over ``FedSim.round`` on the same draws, ``scan_rounds``
equals the per-round loop, it checkpoints where the JAX trainer does, and
it tracks the JAX trainer on the JAX trainer's own client ids (staged by
patching the sampler each trainer module calls). The example twins run on
the CPU and load neither jax nor repro."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core.api as jax_api
import repro_torch.core.api as port_api
from benchmarks.common import make_problem
from repro.comm import faults as jf
from repro.comm.transport import NetworkConfig as JaxNetworkConfig
from repro.comm.transport import SimulatedNetwork as JaxNetwork
from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.api import FederatedTrainer as JaxTrainer
from repro_torch.comm import faults as tf
from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import FederatedTrainer
from repro_torch.core.sampling import sample_clients
from repro_torch.core.sim import FedSim
from repro_torch.models.params import ravel
from test_torch_mesh import ParityModel, TargetData, spawn, trainer_worker
from test_torch_sim import LOSS_RTOL, M, N, _port_loss, staged_init

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
B = 8

#: trainer configurations: FedConfig knobs, FaultConfig knobs or None, and
#: whether the run has a custom network (quickstart_wire.py's)
CONFIGS = {
    "sparse": (dict(compressor="blocktopk"), None, False),
    "wire-two-way": (dict(compressor="sign", wire=True, two_way=True),
                     None, True),
    "faults": (dict(compressor="blocktopk", track_gamma=False, wire=True),
               dict(crash_prob=0.2, corrupt_prob=0.3, corrupt_mode="nan",
                    deadline_s=0.2, seed=2), False),
    "faults-hetero": (dict(compressor="blocktopk", track_gamma=False,
                           wire=True, local_steps=3, local_steps_min=1),
                      dict(crash_prob=0.2, corrupt_prob=0.3,
                           corrupt_mode="nan", deadline_s=0.2, seed=2),
                      False),
}
#: the configurations both trainers run on the same ids (heterogeneous
#: step counts come from each package's own stream, so they stay out)
TRACKED = ["sparse", "wire-two-way", "faults"]
VERDICTS = ("survivors", "rejected", "crashed", "deadline_cut")


def _kw(name):
    fed_kw, _, _ = CONFIGS[name]
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=2, num_clients=M, participating=N)
    kw.update(fed_kw)
    return kw


def _network(name, jax_side=False):
    if not CONFIGS[name][2]:
        return None
    cfg = dict(uplink_mbps=10, downlink_mbps=50, straggler_prob=0.05,
               seed=0)
    if jax_side:
        return JaxNetwork(JaxNetworkConfig(**cfg), M)
    return SimulatedNetwork(NetworkConfig(**cfg), M)


def _port_trainer(name, train=None, init=None):
    _, fault, _ = CONFIGS[name]
    defs, _, data = make_problem("mlp", M)
    if init is None:
        init = params_from_jax(jax.device_get(staged_init(defs)))
    fed = FedConfig(**_kw(name), fault=fault and tf.FaultConfig(**fault))
    tt = FederatedTrainer(fed=fed, train=train or TrainConfig(),
                          loss_fn=_port_loss("mlp"), init_params=init,
                          network=_network(name), device="cpu")
    tt.data = data
    return tt


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("name", CONFIGS)
def test_history_is_a_loop_over_fedsim_round(name):
    """The trainer's history and final state equal a hand-written loop over
    ``FedSim.round``: ids from ``sample_clients`` on a generator seeded with
    ``seed + 1``, then a seed for the round's own generator, then the
    round's batches."""
    rounds = 5
    tt = _port_trainer(name, TrainConfig(seed=3))
    hist = tt.run(rounds, batch_size=B, log=None)
    _, fault, _ = CONFIGS[name]
    sim = FedSim(_port_loss("mlp"), FedConfig(
        **_kw(name), fault=fault and tf.FaultConfig(**fault)),
        network=_network(name), device="cpu")
    defs, _, data = make_problem("mlp", M)
    st = sim.init(params_from_jax(jax.device_get(staged_init(defs))))
    gen = torch.Generator().manual_seed(4)
    for r in range(rounds):
        idx = sample_clients(gen, M, N).numpy()
        rng = torch.Generator().manual_seed(int(torch.randint(
            0, 2 ** 62, (), generator=gen)))
        st, met = sim.round(st, data.round_batches(idx, r, sim.fed.local_steps,
                                                   B), idx, rng)
        want = {k: float(v) for k, v in met.items()}
        want["round"] = r
        assert hist[r] == want
    assert torch.equal(_bits(tt._state.params), _bits(st.params))
    assert torch.equal(_bits(tt._state.errors), _bits(st.errors))


@pytest.mark.parametrize("name", CONFIGS)
def test_scan_rounds_equals_the_loop(name):
    """``scan_rounds=3`` over 7 rounds (chunks of 3, 3, 1) gives the per-round
    loop's history and state, bit for bit — heterogeneous step counts
    included (the draws are staged in the loop's order)."""
    a, b = _port_trainer(name), _port_trainer(name)
    ha = a.run(7, batch_size=B, log=None)
    hb = b.run(7, batch_size=B, scan_rounds=3, log=None)
    assert ha == hb
    for x, y in ((a._state.params, b._state.params),
                 (a._state.errors, b._state.errors),
                 (a._state.opt.vhat, b._state.opt.vhat),
                 (a._state.x_client, b._state.x_client)):
        assert torch.equal(_bits(x), _bits(y))
    assert a._state.round == b._state.round == 7


@pytest.mark.parametrize("rounds,every,scan", [
    (7, 3, 0), (7, 3, 3), (8, 2, 3), (5, 0, 0), (6, 4, 2)])
def test_checkpoints_where_the_jax_trainer_does(rounds, every, scan,
                                                tmp_path, monkeypatch):
    """``checkpoint_every`` writes ``ckpt_round{r}`` directories at the
    JAX trainer's rounds, per round and once per staged chunk, each with
    the round count in its meta."""
    defs, jloss, data = make_problem("mlp", M)
    p0 = staged_init(defs)
    made = {}
    for side in ("jax", "port"):
        wd = tmp_path / side
        wd.mkdir()
        monkeypatch.chdir(wd)
        train = dict(checkpoint_every=every, log_every=100)
        if side == "jax":
            tr = JaxTrainer(fed=JaxFedConfig(**_kw("sparse")),
                            train=JaxTrainConfig(**train), loss_fn=jloss,
                            init_params=p0)
            tr.data = data
        else:
            tr = _port_trainer("sparse", TrainConfig(**train))
        tr.run(rounds, batch_size=B, scan_rounds=scan, log=None)
        made[side] = {ck: json.load(open(wd / ck / "manifest.json"))["meta"]
                      for ck in os.listdir(wd)}
    assert made["port"] == made["jax"]
    assert bool(made["port"]) == bool(every)


def _jax_ids_and_run(name, rounds, monkeypatch):
    """The JAX trainer's run, with the client ids its sampler drew."""
    ids = []
    orig = jax_api.sample_clients

    def recording(key, m, n):
        out = orig(key, m, n)
        ids.append(np.array(out))
        return out

    monkeypatch.setattr(jax_api, "sample_clients", recording)
    _, fault, _ = CONFIGS[name]
    defs, jloss, data = make_problem("mlp", M)
    jt = JaxTrainer(fed=JaxFedConfig(**_kw(name), fault=fault and
                                     jf.FaultConfig(**fault)),
                    train=JaxTrainConfig(), loss_fn=jloss,
                    init_params=staged_init(defs),
                    network=_network(name, jax_side=True))
    jt.data = data
    return jt.run(rounds, batch_size=B, log=None), ids, jt


@pytest.mark.parametrize("name", TRACKED)
def test_trainer_tracks_the_jax_trainer(name, monkeypatch):
    """On the JAX trainer's client ids (its sampler recorded, the port's
    patched to replay them) and the same staged init: per-round losses
    within ``LOSS_RTOL``; the host counters (``bits``, wire bytes,
    simulated times) and the fault verdicts equal; the final params within
    1e-4."""
    rounds = 8
    jhist, ids, jt = _jax_ids_and_run(name, rounds, monkeypatch)
    replay = iter(ids)
    monkeypatch.setattr(port_api, "sample_clients",
                        lambda gen, m, n: torch.tensor(next(replay)))
    tt = _port_trainer(name)
    thist = tt.run(rounds, batch_size=B, log=None)
    assert len(thist) == len(jhist) == rounds
    for j, t in zip(jhist, thist):
        assert set(j) == set(t)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        for k in j:
            if k.startswith("wire") or k in VERDICTS + (
                    "bits", "round_time_s", "sim_time_s", "round"):
                assert t[k] == j[k], k
    if CONFIGS[name][1]:
        assert sum(t["rejected"] for t in thist) > 0
        assert sum(t["crashed"] + t["deadline_cut"] for t in thist) > 0
    jflat = np.asarray(jax.flatten_util.ravel_pytree(jt.params)[0])
    np.testing.assert_allclose(tt._state.params.numpy(), jflat, atol=1e-4)


def test_params_are_in_jax_shapes_and_mesh_is_refused():
    """The simulation trainer's params are views in JAX shapes; the mesh
    trainer refuses a model built at another tp than the mesh's model axis
    before it touches the process group, and the simulation backend
    without a loss or an init."""
    tt = _port_trainer("sparse")
    defs, _, _ = make_problem("mlp", M)
    shapes = {k: tuple(v.shape) for k, v in tt.params.items()}
    assert shapes == {k: tuple(d.shape) for k, d in defs.items()}
    assert torch.equal(ravel(tt.params)[0], tt._state.params)
    tp2 = SimpleNamespace(mesh_dim_names=("data", "model"),
                          mesh=torch.zeros(2, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="model is built for tp=1 but "
                                         "the mesh's model axis is 2"):
        FederatedTrainer(fed=FedConfig(), mesh=tp2, model=ParityModel(),
                         lm_data=TargetData(2), device="cpu")
    with pytest.raises(ValueError, match="loss_fn and init_params"):
        FederatedTrainer(fed=FedConfig(), device="cpu")


def test_mesh_trainer_loop_equals_staged_rounds(tmp_path):
    """``FederatedTrainer(mesh=...)`` on 4 CPU ranks: the per-round loop and
    ``scan_rounds=3`` staging (a chunk of 3, then 1) give the same history
    and the same final state, to the bit; the loss falls."""
    out = spawn(trainer_worker, 4, str(tmp_path / "ckpt"))
    assert len(out["loop"]) == len(out["staged"]) == 4
    assert out["loop"] == out["staged"]
    assert set(out["loop"][0]) == {"loss", "wire_up_bytes", "round"}
    assert out["loop"][-1]["loss"] < out["loop"][0]["loss"]
    for key, a in out["state"].items():
        b = out["staged_state"][key]
        for x, y in zip(_flat(a), _flat(b)):
            assert torch.equal(x, y), key


@pytest.mark.parametrize("example", ["quickstart_torch.py",
                                     "quickstart_wire_torch.py"])
def test_example_twins_run_on_the_cpu(example):
    """Each twin runs 3 rounds on the CPU, prints its rounds, and loads
    neither jax nor repro."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['{example}', '--device', 'cpu', '--rounds', '3']\n"
            f"runpy.run_path({os.path.join(ROOT, 'examples', example)!r}, "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]", out.stdout
    assert any(line.startswith("round   2") for line in lines), out.stdout


def _flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [tree]
