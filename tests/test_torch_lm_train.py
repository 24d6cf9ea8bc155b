"""Federated LM training in the port (``FederatedLMData``, the mesh round
on a ``models.model.Model``, ``launch/train.py``) against the JAX package,
on the CPU at smoke size.

* ``FederatedLMData`` draws the reference's tokens, bitwise.
* The mesh round on the gemma2-2b smoke config (fedcams, blockwise top-k
  1/64 over the sparse collective, fused ingest), 2 gloo CPU ranks against
  the JAX mesh on 2 forced host devices, 3 rounds, each restarted from the
  JAX state before it. The JAX side runs ``mesh_sparse_impl="jnp"`` (its
  kernel-routed mesh fails ``check_vma``) and ``check_vma=False`` (its
  ``launch/train.py`` fails ``check_vma`` on the loss at every config
  under jax 0.9; at tp = 1 the check guards nothing). The port runs its
  plain path and, in the same ranks, its kernel-routed path
  (``KernelImpl`` on the CPU runs the kernels' twins), which must be
  bitwise the plain one.
* The train CLI for 2 rounds on ``--device cpu``: its lines, its
  checkpoint (read by both packages' ``load_pytree``), staged rounds
  equal to the loop, and its refusals.
"""
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import FederatedLMData as JaxLMData
from repro_torch.configs import FedConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import FederatedLMData
from repro_torch.launch import train as ttrain
from test_torch_mesh import spawn

torch.set_num_threads(1)

FIELDS = ("params", "m", "v", "vhat", "errors")
M, K, GB, SEQ, R = 2, 2, 4, 16, 3
FED = dict(algorithm="fedcams", compressor="topk", compress_ratio=1 / 64,
           aggregation="sparse", mesh_sparse_impl="jnp", local_steps=K,
           num_clients=M, eta=0.5, eta_l=0.05, client_axes=("data",))


@pytest.mark.parametrize("kw", [dict(num_clients=3, vocab_size=100, seed=1),
                                dict(num_clients=2, vocab_size=512, seed=0,
                                     alpha=0.1)])
def test_lm_data_draws_the_reference_tokens(kw):
    a, b = FederatedLMData(**kw), JaxLMData(**kw)
    assert np.array_equal(a.unigram, b.unigram)
    for got, want in ((a.client_batch(1, 5, 3, 9), b.client_batch(1, 5, 3, 9)),
                      (a.round_batches([0, 1], 2, 2, 3, 7),
                       b.round_batches([0, 1], 2, 2, 3, 7)),
                      (a.mesh_batch(1, 2, 2 * kw["num_clients"], 8),
                       b.mesh_batch(1, 2, 2 * kw["num_clients"], 8))):
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


# -- the mesh round against the JAX mesh -------------------------------------

_JAX_SIDE = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import FedConfig, TrainConfig
from repro.configs.registry import get_arch
from repro.core.mesh import (build_fed_round, fed_batch_defs, fed_state_defs,
                             init_fed_state, mesh_metric_specs)
from repro.data.synthetic import FederatedLMData
from repro.launch.mesh import make_mesh
from repro.models import params as pdefs
from repro.models.model import Model
from repro.sharding.rules import ParallelContext

fed = FedConfig(**%(fed)r)
train = TrainConfig(global_batch=%(gb)d, seq_len=%(seq)d,
                    remat_policy="none")
model = Model(get_arch("gemma2-2b").smoke, tp=1)
ctx = ParallelContext(client_axes=("data",), num_clients=fed.num_clients)
mesh = make_mesh((fed.num_clients, 1), ("data", "model"))
spec = lambda defs: jax.tree.map(lambda d: d.spec, defs, is_leaf=pdefs.is_def)
step = jax.jit(compat.shard_map(
    build_fed_round(model, fed, train, ctx), mesh=mesh,
    in_specs=(spec(fed_state_defs(model, fed)),
              spec(fed_batch_defs(model, fed, train)), P()),
    out_specs=(spec(fed_state_defs(model, fed)), mesh_metric_specs(fed)),
    check_vma=False))
data = FederatedLMData(num_clients=fed.num_clients,
                       vocab_size=model.cfg.vocab_size, seed=0)
state = init_fed_state(model, fed, jax.random.PRNGKey(0))
out = {}

def put(tag, st):
    for f in %(fields)r:
        flat, _ = jax.tree_util.tree_flatten_with_path(getattr(st, f))
        for path, leaf in flat:
            key = "/".join(p.key for p in path)
            out[f"{tag}/{f}/{key}"] = np.asarray(leaf).astype(np.float32)

put("init", state)
for r in range(%(rounds)d):
    raw = data.mesh_batch(r, fed.local_steps, train.global_batch,
                          train.seq_len)
    state, met = step(state, {k: jnp.asarray(v) for k, v in raw.items()},
                      jnp.int32(r))
    put(str(r), state)
    out[f"{r}/loss"] = np.float32(met["loss"])
    out[f"{r}/wire_up_bytes"] = np.float32(met["wire_up_bytes"])
np.savez(%(path)r, **out)
print("ok")
"""


def _tree(jx, tag, field):
    """The nested dict of one state field from the JAX side's npz."""
    out = {}
    pre = f"{tag}/{field}/"
    for key, val in jx.items():
        if key.startswith(pre):
            node = out
            parts = key[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return out


def _jax_state(jx, tag, r):
    st = {f: _tree(jx, tag, f) for f in FIELDS}
    st["round"] = np.int32(r)
    return st


def mesh_worker(rank, world, starts):
    """Each round from the JAX state before it, on the port's plain path
    and on its kernel-routed path (the kernels' twins on the CPU); rank 0
    returns every round's global state and metrics for both."""
    from repro_torch.convert import mesh_state_from_jax
    from repro_torch.core import mesh as meshmod
    from repro_torch.kernels.ops import KernelImpl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import ParallelContext
    model = Model(get_arch("gemma2-2b").smoke)
    train = TrainConfig(global_batch=GB, seq_len=SEQ, remat_policy="none")
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    ctx = ParallelContext(client_axes=("data",), num_clients=world,
                          mesh=mesh)
    data = FederatedLMData(num_clients=world, vocab_size=model.cfg.vocab_size,
                           seed=0)
    out = {}
    for impl in ("jnp", "kernel"):
        fed = FedConfig(**dict(FED, mesh_sparse_impl=impl,
                               fused_ingest="kernel" if impl == "kernel"
                               else "auto"))
        rnd = meshmod.build_fed_round(model, fed, train, ctx,
                                      kernel_impl=KernelImpl(device="cpu"))
        rows = []
        for r, start in enumerate(starts):
            state = meshmod.shard_fed_state(mesh_state_from_jax(start), model,
                                            fed, ctx, "cpu")
            batch = meshmod.shard_batch(data.mesh_batch(r, K, GB, SEQ), model,
                                        fed, train, ctx, "cpu")
            state, met = rnd(state, batch, r)
            full = meshmod.gather_fed_state(state, model, fed, ctx)
            rows.append(dict({f: getattr(full, f) for f in FIELDS},
                             **{k: float(v) for k, v in met.items()}))
        out[impl] = rows
    return out


@pytest.fixture(scope="module")
def jax_vs_port():
    from conftest import run_forced_devices
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax_lm_mesh.npz")
        run_forced_devices(_JAX_SIDE % dict(fed=FED, gb=GB, seq=SEQ,
                                            fields=FIELDS, rounds=R,
                                            path=path),
                           devices=M, timeout=900)
        jx = dict(np.load(path))
    starts = [_jax_state(jx, "init" if r == 0 else str(r - 1), r)
              for r in range(R)]
    return jx, spawn(mesh_worker, M, starts)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("r", range(R))
def test_mesh_round_matches_the_jax_mesh(jax_vs_port, r):
    """Round r from the JAX state before it. ``wire_up_bytes`` bitwise;
    the loss within 1e-5 relative (two fp32 transformers summing in their
    own orders). Each leaf against the leaf's largest |value| in JAX's
    state: params within 2e-6, the EF rows and m, v, v̂ within 1e-4 — the
    local deltas differ in the last bits, and m, v and the EF residual
    carry them at the deltas' scale, while the step moves params by at most
    η·m/√v̂ (measured here: params ≤ 1.8e-7, the rest ≤ 1.8e-5)."""
    jx, port = jax_vs_port
    row = port["jnp"][r]
    assert row["wire_up_bytes"] == float(jx[f"{r}/wire_up_bytes"])
    assert row["loss"] == pytest.approx(float(jx[f"{r}/loss"]), rel=1e-5)
    for f in FIELDS:
        want = dict(_leaves(_tree(jx, str(r), f)))
        got = dict(_leaves(row[f]))
        assert sorted(got) == sorted(want), f
        for path, w in want.items():
            g = got[path].float().numpy()
            scale = max(np.abs(w).max(), 1e-30)
            err = float(np.abs(g - w).max()) / scale
            assert err <= (2e-6 if f == "params" else 1e-4), (f, path, err)


def test_kernel_routed_mesh_round_is_the_plain_one(jax_vs_port):
    """``KernelImpl`` (the selection and the fused ingest through the
    kernels' twins) gives the plain path's states and metrics to the bit,
    every round: the path ``chip_smoke.py`` route o runs on the card."""
    _, port = jax_vs_port
    for a, b in zip(port["jnp"], port["kernel"]):
        assert a["loss"] == b["loss"]
        assert a["wire_up_bytes"] == b["wire_up_bytes"]
        for f in FIELDS:
            for (pa, ta), (pb, tb) in zip(_leaves(a[f]), _leaves(b[f])):
                assert pa == pb and torch.equal(ta, tb), (f, pa)


# -- the CLI --------------------------------------------------------------------


def _lines(text, head):
    return [ln for ln in text.splitlines() if ln.startswith(head)]


def test_train_cli_runs_two_rounds_and_checkpoints(tmp_path, capfd):
    """Two rounds on 2 gloo CPU ranks: the reference's lines, finite
    losses, and a checkpoint in the JAX package's layout that both
    packages' ``load_pytree`` restore (the EF rows client-major (m, ...))."""
    path = str(tmp_path / "ckpt")
    ttrain.main(["--smoke", "--dp", "2", "--rounds", "2", "--seq-len", "16",
                 "--global-batch", "4", "--aggregation", "sparse",
                 "--device", "cpu", "--checkpoint", path])
    out = capfd.readouterr().out
    head = _lines(out, "arch=")
    assert head == ["arch=gemma2-2b-smoke params=0.4M clients=2 "
                    "algo=fedcams/topk mesh=2x1"], out
    rounds = _lines(out, "round ")
    assert [ln.split()[1] for ln in rounds] == ["0", "1"]
    assert all(np.isfinite(float(ln.split()[3])) for ln in rounds)
    assert _lines(out, "checkpoint -> ")
    from repro.checkpoint import load_pytree as jax_load
    from repro.configs.base import FedConfig as JaxFed
    from repro.core.mesh import init_fed_state as jax_init
    from repro.models.model import Model as JaxModel
    from repro.configs.registry import get_arch as jax_arch
    jfed = JaxFed(**dict(FED, mesh_sparse_impl="auto"))
    like = jax.device_get(jax_init(JaxModel(jax_arch("gemma2-2b").smoke),
                                   jfed, jax.random.PRNGKey(0))._asdict())
    tree, meta = jax_load(path, like)
    assert meta == {"arch": "gemma2-2b-smoke", "rounds": 2}
    assert int(tree["round"]) == 2
    assert tree["errors"]["embed"]["table"].shape == (2, 512, 128)
    from repro_torch.checkpoint import load_pytree
    mine, _ = load_pytree(path, like)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for (_, a), (
        _, b) in zip(_leaves(mine["params"]), _leaves(tree["params"])))


def test_staged_rounds_equal_the_loop():
    """``--scan-rounds 2`` (staged rounds through ``build_fed_rounds_scan``)
    gives the per-round loop's losses and wire bytes to the bit."""
    cfg = get_arch("gemma2-2b").smoke
    fed = FedConfig(**FED)
    train = TrainConfig(global_batch=GB, seq_len=SEQ, rounds=3,
                        remat_policy="none")
    loop = ttrain.launch(cfg, fed, train, dp=M, device="cpu", log=None)
    staged = ttrain.launch(cfg, fed, train, dp=M, device="cpu",
                           scan_rounds=2, log=None)
    key = lambda h: [(x["round"], x["loss"], x["wire_up_bytes"])
                     for x in h["history"]]
    assert key(loop) == key(staged) and len(key(loop)) == 3
    assert loop["finite"] and loop["peak_bytes"] is None


def test_train_cli_refusals():
    base = ["--smoke", "--dp", "2", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="tp = 1"):
        ttrain.main(base + ["--tp", "2"])
    with pytest.raises(SystemExit):
        ttrain.main(base + ["--deadline-s", "1.0"])
    with pytest.raises(SystemExit):
        ttrain.main(base + ["--async-buffer", "2"])
    with pytest.raises(NotImplementedError, match="RG-LRU"):
        ttrain.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                     "cpu"])
