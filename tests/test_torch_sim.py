"""The whole FedSim round: the port against the JAX FedSim on staged
inputs — client ids drawn on the JAX side, the same numpy batches, and
initial params drawn with numpy from a seed and handed to both. Trajectories
are held to a tolerance (XLA and PyTorch sum the local gradients in
different orders, and XLA:CPU contracts the jitted server step into FMAs);
the host-side counters (``bits``, the wire bytes, the simulated times) are
held equal. tests/test_torch_sim_stages.py holds the bitwise round-0 EF
checks and the other configurations.

The initial params are not ``repro.models.params.init_params``: it keys
each leaf's draw by Python's ``hash()`` of the leaf's path, which is salted
per process (``PYTHONHASHSEED``), so every process drew another init, and
an init that puts two coordinates of one block in a near-tie lets the two
packages' last-bit differences pick different coordinates
(test_staged_init_is_the_same_in_every_process)."""
import dataclasses
import os
import subprocess
import sys

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


def staged_init(defs, seed: int = 0):
    """A JAX params tree for ``defs`` drawn with numpy from ``seed``: leaf i
    (in flattening order) is ``default_rng((seed, i)).standard_normal`` ×
    its scale, or zeros/ones — the same bits in every process."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(defs,
                                                         is_leaf=jp.is_def)
    leaves = []
    for i, (_, d) in enumerate(flat):
        if d.init == "zeros":
            a = np.zeros(d.shape, d.dtype)
        elif d.init == "ones":
            a = np.ones(d.shape, d.dtype)
        else:
            a = np.random.default_rng((seed, i)).standard_normal(d.shape)
            a = (a * d.scale).astype(d.dtype)
        leaves.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _staged_rounds(data, rounds, seed=1):
    rng = jax.random.PRNGKey(seed)
    out = []
    for r in range(rounds):
        rng, k1, k2 = jax.random.split(rng, 3)
        idx = np.array(jax_sample(k1, M, N))
        out.append((idx, data.round_batches(idx, r, K, B), k2))
    return out


#: the host-side metrics a round adds, held equal (not close) to JAX's
EXACT_KEYS = ("bits", "wire_up_bytes", "wire_up_bytes_attempted",
              "wire_tier1_bytes", "wire_tier2_bytes", "wire_down_bytes",
              "wire_bytes", "round_time_s", "sim_time_s")


def _run_both(model, kw, rounds, port_hook=None):
    """``port_hook(ts)``, if given, sees the port's FedSim before the first
    round."""
    defs, jloss, data = make_problem(model, M)
    p0 = staged_init(defs)
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss(model), FedConfig(**kw), device="cpu")
    if port_hook is not None:
        port_hook(ts)
    jstate = js.init(p0)
    tstate = ts.init(params_from_jax(jax.device_get(p0)))
    hist = []
    for idx, b, key in _staged_rounds(data, rounds):
        jstate, jm = js.round(jstate, jax.tree.map(jnp.asarray, b),
                              jnp.asarray(idx), key)
        tstate, tm = ts.round(tstate, b, idx)
        hist.append((float(jm["loss"]), float(tm["loss"]),
                     float(jm["gamma"]), float(tm["gamma"])))
        assert set(tm) == set(jm) - {"crashed", "deadline_cut"}
        for key_ in EXACT_KEYS:
            if key_ in jm:
                assert tm[key_] == jm[key_], key_
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


SLICE2 = {   # the dense uplink and the wire, by configuration
    "sign": dict(compressor="sign"),
    "sign-wire": dict(compressor="sign", wire=True, wire_pack_impl="pallas"),
    "blocktopk-dense": dict(compressor="blocktopk", sparse_uplink=False),
    "blocktopk-dense-wire": dict(compressor="blocktopk", sparse_uplink=False,
                                 wire=True, wire_pack_impl="pallas"),
    "blocktopk-sparse-bf16-wire": dict(compressor="blocktopk", wire=True,
                                       wire_value_dtype="bfloat16"),
    "int8": dict(compressor="int8"),
    "none": dict(compressor="none"),
}


@pytest.mark.parametrize("model,name", [
    (model, name) for name in SLICE2 for model in ("mlp", "convmixer")
    if model == "mlp" or name in ("sign", "sign-wire", "blocktopk-dense",
                                  "blocktopk-dense-wire")])
def test_fedsim_dense_uplink_and_wire_track_jax_fedsim(model, name):
    """FedCAMS over the dense compressed uplink (sign in memory through the
    sign_ef twin, blocktopk through the topk_ef twin, int8 and identity as
    plain torch) and over the packed wire (the pack/unpack twins on the
    port's side, the Pallas interpreter on the JAX side with
    ``wire_pack_impl="pallas"``), plus the sparse uplink over a narrowed
    wire. 10 rounds: per-round loss within 1e-3 relative; ``bits``, the
    wire bytes, ``round_time_s`` and ``sim_time_s`` equal
    (``_run_both``); final params within 1e-4 — 1e-3 for int8, whose
    jitted JAX scale is one ulp off the eager function the port computes
    on some rounds (test_torch_dense_uplink.py::
    test_int8_scale_is_the_eager_division), so a value near a
    quantization boundary can round to the next step."""
    kw = _cfg("b", **SLICE2[name])
    hist, jflat, tstate, ts = _run_both(model, kw, rounds=10)
    assert ts.sparse == (name == "blocktopk-sparse-bf16-wire")
    assert (ts.codec is not None) == kw.get("wire", False)
    np.testing.assert_allclose(hist[:, 1], hist[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist[:, 3], hist[:, 2], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tstate.params.numpy(), jflat,
                               atol=1e-3 if name == "int8" else 1e-4)
    assert tstate.round == 10 and int(tstate.opt.t) == 10


def test_fedsim_sparse_int8_wire_tracks_jax_fedsim():
    """The sparse uplink over the int8 wire (``wire_value_dtype="int8"``,
    ROADMAP Queue 3 item 6), 10 MLP rounds: per-round loss within
    ``LOSS_RTOL`` and the host counters equal, as for the other wires; the
    final params within a bound argued from the measured cause of their
    drift.

    The cause: the port's codec is the eager JAX codec byte for byte
    (test_torch_wire_rows.py::test_blocktopk_int8_codec_is_the_eager_jax_
    codec), but the two packages' local training differs in the last bits,
    and a total that close to a half step of its block's int8 grid rounds
    to the neighbouring step. Measured in this run: round 2, client 0, the
    total at coordinate 930 is -6.2762052e-03 on the JAX side and
    -6.2762201e-03 in the port, and they decode one step (1.93e-4) apart;
    x is then 4.8e-5 apart there and nowhere else over 1e-6. (The jitted
    JAX scale's one-ulp differences moved no quantized value on the codec
    test's 360 blocks, nor at coordinate 930 here.)

    The bound: a flip moves a coordinate's mean delta by s/n for a step s,
    so n flips a round move it by at most s_max, the largest step of the
    run (max |selected value| / 127, recorded here). To first order the
    FedAMS step passes a change δ of the mean delta on to x as at most
    η·δ/√ε over the following rounds (the momentum passes on (1-β₁)·Σβ₁ᵗ ≤ 1
    of it, and v̂ ≥ ε under option 1), and as much again through v̂; over T
    rounds, 2·η·T·s_max/√ε. Measured: 3.5e-3 against a bound of 0.14."""
    steps = []

    def record(ts):
        roundtrip = ts.codec.roundtrip_selection

        def recorded(sel, d):
            steps.append(float(sel.vals.abs().max()) / 127)
            return roundtrip(sel, d)
        ts.codec = dataclasses.replace(ts.codec,
                                       roundtrip_selection=recorded)

    kw = _cfg("b", wire=True, wire_value_dtype="int8")
    rounds = 10
    hist, jflat, tstate, ts = _run_both("mlp", kw, rounds, port_hook=record)
    assert ts.sparse and len(steps) == rounds * N
    np.testing.assert_allclose(hist[:, 1], hist[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist[:, 3], hist[:, 2], rtol=1e-3, atol=1e-6)
    bound = 2 * kw["eta"] * rounds * max(steps) / np.sqrt(kw["eps"])
    np.testing.assert_allclose(tstate.params.numpy(), jflat, rtol=0,
                               atol=bound)
    assert tstate.round == rounds and int(tstate.opt.t) == rounds


def _jax_randk_draws(key, n: int, d: int, k: int) -> torch.Tensor:
    """The positions a JAX FedSim round with key ``key`` draws for randk,
    in ``randk_positions``' layout: client i's from ``fold_in(fold_in(key,
    i), 0)`` (the round's per-client key, then ``ef_compress``'s leaf key),
    γ's from ``fold_in(key, 999983)``, the downlink's from
    ``fold_in(key, 10**6)``."""
    keys = [jax.random.fold_in(jax.random.fold_in(key, i), 0)
            for i in range(n)]
    keys += [jax.random.fold_in(key, 999983), jax.random.fold_in(key, 10**6)]
    return torch.from_numpy(np.stack([
        np.array(jax.random.permutation(kk, d)[:k]) for kk in keys])).long()


@pytest.mark.parametrize("extra", [dict(), dict(client_chunk=2),
                                   dict(two_way=True)],
                         ids=["in-memory", "chunked", "two-way"])
def test_fedsim_randk_tracks_jax_fedsim(extra, monkeypatch):
    """randk 1/8 with γ on: the port's round draws its positions through
    ``randk_positions``, patched here to return what the JAX round draws
    from its key (``_jax_randk_draws``), so both packages keep the same
    coordinates. 10 MLP rounds: per-round loss and γ within ``LOSS_RTOL``,
    ``bits`` equal, final params within 1e-4 (the ROADMAP gate)."""
    from repro_torch.core import sim as simmod
    rounds = 10
    _, _, data = make_problem("mlp", M)
    keys = iter([s[2] for s in _staged_rounds(data, rounds)])
    monkeypatch.setattr(simmod, "randk_positions",
                        lambda rng, d, k, count, device: _jax_randk_draws(
                            next(keys), count - 2, d, k))
    kw = _cfg("b", compressor="randk", compress_ratio=1 / 8, **extra)
    hist, jflat, tstate, ts = _run_both("mlp", kw, rounds)
    assert ts._randk and not ts.sparse
    np.testing.assert_allclose(hist[:, 1], hist[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist[:, 3], hist[:, 2], rtol=LOSS_RTOL)
    assert (hist[:, 3] > 0).all()
    np.testing.assert_allclose(tstate.params.numpy(), jflat, atol=1e-4)
    if extra.get("two_way"):
        assert not torch.equal(tstate.x_client, tstate.params)


def test_staged_init_is_the_same_in_every_process():
    """The trajectory tests' init is drawn from numpy, so it is the same
    under any ``PYTHONHASHSEED``; the reference's ``init_params`` is not
    (it keys leaves by the salted ``hash()`` of their paths), which is why
    the tests do not use it."""
    code = ("import hashlib, jax, numpy as np\n"
            "from benchmarks.common import make_problem\n"
            "from repro.models.params import init_params\n"
            "from test_torch_sim import staged_init\n"
            "defs = make_problem('mlp', 4)[0]\n"
            "h = lambda t: hashlib.sha1(np.asarray(jax.flatten_util."
            "ravel_pytree(t)[0]).tobytes()).hexdigest()\n"
            "print(h(staged_init(defs)), h(init_params(defs, "
            "jax.random.PRNGKey(0))))\n")
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([os.path.join(root, "src"),
                                               here, root]))
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        outs.append(out.stdout.split())
    assert outs[0][0] == outs[1][0]      # staged: one init everywhere
    assert outs[0][1] != outs[1][1]      # reference: one init per process
