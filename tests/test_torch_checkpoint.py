"""The port's checkpoint store against ``repro.checkpoint``: the same files
for the same state, each package reading the other's checkpoints bit for
bit (fp32 and int8 server state), and the same error messages when a
restore is refused — bf16 state included, which neither package restores
(ROADMAP Queue 3 item 7)."""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.api import FederatedTrainer as JaxTrainer
from repro.core.sim import SimState as JaxSimState
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.checkpoint.store import _items
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.convert import (mesh_state_from_jax, params_from_jax,
                                 state_from_jax, state_to_jax)
from repro_torch.core.api import FederatedTrainer
from repro_torch.models.params import ravel
from test_torch_mesh import D, spawn, trainer_worker
from test_torch_sim import M, _port_loss, staged_init

torch.set_num_threads(1)

DTYPES = ["float32", "int8"]


def _fed(sd):
    return dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
                local_steps=2, num_clients=M, participating=4,
                compressor="blocktopk", server_state_dtype=sd)


def _trainers(sd, rounds=2):
    """A JAX and a port trainer on the same config and staged init, each
    run ``rounds`` rounds (their states differ: their client ids do)."""
    defs, jloss, data = make_problem("mlp", M)
    p0 = staged_init(defs)
    jt = JaxTrainer(fed=JaxFedConfig(**_fed(sd)), train=JaxTrainConfig(),
                    loss_fn=jloss, init_params=p0)
    tt = FederatedTrainer(fed=FedConfig(**_fed(sd)), train=TrainConfig(),
                          loss_fn=_port_loss("mlp"),
                          init_params=params_from_jax(jax.device_get(p0)),
                          device="cpu")
    jt.data = tt.data = data
    jt.run(rounds, batch_size=8, log=None)
    tt.run(rounds, batch_size=8, log=None)
    return jt, tt


def _leaves(tree):
    """keystr → numpy array (raw words for bfloat16)."""
    out = {}
    for key, leaf in _items(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16
                    else leaf).numpy()
        out[key] = np.asarray(leaf)
    return out


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for key in la:
        x, y = la[key], lb[key]
        assert x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


class _Pair(NamedTuple):
    left: object
    right: object


def test_keys_are_jax_keystr():
    """The flattening order and key strings of ``jax.tree_util``'s
    ``keystr`` over dicts (sorted), NamedTuples, lists, tuples and None."""
    tree = {"b": [1, (2, 3)], "a": _Pair(4, {"z": 5, "y": None}), "c": 6}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert [k for k, _ in _items(tree)] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    assert [v for _, v in _items(tree)] == [v for _, v in flat]


@pytest.mark.parametrize("sd", ["float32", "int8", "bfloat16"])
def test_same_state_same_files(sd, tmp_path):
    """A JAX trainer's state, carried into the port (``state_from_jax``)
    and saved back through ``state_to_jax``: the port's files hold the JAX
    checkpoint's keys, shapes, dtypes and bytes."""
    jt, _ = _trainers(sd)
    host = jax.device_get(jt._state._asdict())
    port_state = state_from_jax(host)
    unravel = ravel(params_from_jax(host["params"]))[1]
    jax_save(str(tmp_path / "jax"), host, {"round": 2})
    save_pytree(str(tmp_path / "port"), state_to_jax(port_state, unravel),
                {"round": 2})
    mj, mt = (json.load(open(tmp_path / w / "manifest.json"))
              for w in ("jax", "port"))
    assert mj == mt
    dj, dt = (np.load(tmp_path / w / "arrays.npz") for w in ("jax", "port"))
    assert sorted(dj.files) == sorted(dt.files)
    for f in dj.files:
        assert dj[f].dtype == dt[f].dtype and dj[f].shape == dt[f].shape
        assert dj[f].tobytes() == dt[f].tobytes(), f


@pytest.mark.parametrize("sd", DTYPES)
def test_port_checkpoint_restores_into_the_jax_trainer(sd, tmp_path):
    """``FederatedTrainer.save`` read by ``repro.checkpoint.load_pytree``
    into the JAX trainer's state, bit for bit; the JAX FedSim then runs a
    round from it."""
    jt, tt = _trainers(sd)
    tt.save(str(tmp_path))
    like = jax.device_get(jt._state._asdict())
    tree, meta = jax_load(str(tmp_path), like)
    assert meta == {"round": 2, "algo": "fedcams"}
    _assert_same_tree(tree, state_to_jax(tt._state, tt._sim.unravel))
    jt._state = JaxSimState(**{k: (jax.tree.map(jnp.asarray, v)
                                   if k not in ("bits", "round") else int(v))
                               for k, v in tree.items()})
    jt.run(1, batch_size=8, log=None)
    assert np.isfinite(jt.history[-1]["loss"])


@pytest.mark.parametrize("sd", DTYPES)
def test_jax_checkpoint_restores_into_the_port(sd, tmp_path):
    """A JAX trainer's checkpoint read by the port's ``load_pytree`` and
    carried into a ``SimState`` (``state_from_jax``): the JAX state bit for
    bit; the port then runs a round from it."""
    jt, tt = _trainers(sd)
    jt.save(str(tmp_path))
    like = state_to_jax(tt._state, tt._sim.unravel)
    tree, meta = load_pytree(str(tmp_path), like)
    assert meta == {"round": 2, "algo": "fedcams"}
    _assert_same_tree(tree, jax.device_get(jt._state._asdict()))
    tt._state = state_from_jax(tree)
    _assert_same_tree(state_to_jax(tt._state, tt._sim.unravel),
                      jax.device_get(jt._state._asdict()))
    tt.run(1, batch_size=8, log=None)
    assert np.isfinite(tt.history[-1]["loss"])


def test_port_roundtrip_keeps_devices_and_types(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).view(2, 3),
            "n": 7, "q": np.int8([1, -2])}
    save_pytree(str(tmp_path), tree)
    back, meta = load_pytree(str(tmp_path), tree)
    assert meta == {}
    assert isinstance(back["w"], torch.Tensor) and torch.equal(back["w"],
                                                               tree["w"])
    assert isinstance(back["q"], np.ndarray) and back["n"] == 7


def _jax_like(jt, what):
    like = jax.device_get(jt._state._asdict())
    if what == "structure":
        like["extra"] = np.zeros(3, np.float32)
    elif what == "shape":
        like["errors"] = np.zeros((M + 1, like["errors"].shape[1]),
                                  np.float32)
    elif what == "dtype":
        like["server_error"] = like["server_error"].astype(np.float64)
    return like


def _port_like(tt, what):
    like = state_to_jax(tt._state, tt._sim.unravel)
    if what == "structure":
        like["extra"] = torch.zeros(3)
    elif what == "shape":
        like["errors"] = torch.zeros(M + 1, like["errors"].shape[1])
    elif what == "dtype":
        like["server_error"] = like["server_error"].double()
    return like


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("what", ["structure", "shape", "dtype", "bfloat16"])
def test_refused_restores_raise_what_jax_raises(what, writer, tmp_path):
    """A restore target with an extra key, a wrong shape or a wrong dtype,
    and a bf16-state checkpoint (its npz holds ``|V2`` words where the
    manifest says ``bfloat16``): the port's ``load_pytree`` raises the JAX
    one's message, whichever package wrote the files."""
    sd = "bfloat16" if what == "bfloat16" else "float32"
    jt, tt = _trainers(sd, rounds=1)
    (jt if writer == "jax" else tt).save(str(tmp_path))
    with pytest.raises(ValueError) as jax_err:
        jax_load(str(tmp_path), _jax_like(jt, what))
    with pytest.raises(ValueError) as port_err:
        load_pytree(str(tmp_path), _port_like(tt, what))
    assert str(port_err.value) == str(jax_err.value)
    if what == "bfloat16":
        assert "|V2" in str(port_err.value)
        assert "the checkpoint files disagree" in str(port_err.value)


def test_writes_are_atomic(tmp_path):
    """A save leaves only the two files: the tmp names are renamed."""
    save_pytree(str(tmp_path), {"a": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == ["arrays.npz", "manifest.json"]


def test_mesh_save_is_read_by_the_jax_package(tmp_path):
    """A mesh trainer's ``save`` at fp32 state (4 CPU ranks, rank 0
    writes the gathered ``FedMeshState``): ``repro.checkpoint.load_pytree``
    reads it with the port's leaves — keys, shapes, dtypes and bytes —
    and what the JAX package saves back, the port reads as the same
    ``FedMeshState`` to the bit."""
    path = str(tmp_path / "mesh")
    port = spawn(trainer_worker, 4, path)["state"]
    like = jax.tree.map(lambda t: np.zeros(t.shape, t.numpy().dtype), port)
    jtree, meta = jax_load(path, like)
    _assert_same_tree(jtree, port)
    assert meta["round"] == 4 and meta["algo"] == "fedcams"
    assert np.asarray(jtree["errors"]["w"]).shape == (4, D)
    jax_save(str(tmp_path / "back"), jtree, meta)
    back, _ = load_pytree(str(tmp_path / "back"), port)
    _assert_same_tree(back, port)
    st = mesh_state_from_jax(back)
    for name in st._fields:
        _assert_same_tree(getattr(st, name), port[name])
