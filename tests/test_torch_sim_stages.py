"""FedSim pieces against the JAX package: the round-0 EF rows given the
same deltas (bitwise), other configurations of the round (global top-k,
uncompressed algorithms, quantized state, local rules), the fused-ingest
resolution, and ``run_rounds``. Staging helpers come from
tests/test_torch_sim.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import stages as jst
from repro.core.sim import FedSim as JaxSim
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.sim import FedSim
from repro_torch.core.stages import client_uplink, client_uplink_sparse
from test_torch_dense_uplink import SIGN_ULP, _ulps
from test_torch_sim import (LOSS_RTOL, M, N, _cfg, _port_loss, _run_both,
                            _staged_rounds, staged_init)

torch.set_num_threads(1)


@pytest.mark.parametrize("model", ["mlp", "convmixer"])
def test_round0_ef_rows_bitwise_given_the_same_deltas(model):
    """Round 0 of both packages from the JAX side's deltas: the port's
    uplink (the topk_ef_sparse twin, in place on the (m, d) buffer) leaves
    the EF buffer and the selections bitwise where the JAX stages do. The
    port's own deltas agree with the JAX deltas to float tolerance."""
    defs, jloss, data = make_problem(model, M)
    kw = _cfg("b")
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss(model), FedConfig(**kw), device="cpu")
    p0 = staged_init(defs)
    jstate = js.init(p0)
    tstate = ts.init(params_from_jax(jax.device_get(p0)))
    idx, b, key = _staged_rounds(data, 1)[0]
    jb = jax.tree.map(jnp.asarray, b)
    jdelta, _ = js._train_block(js.unravel(jstate.x_client),
                                jstate.x_client, jb, key, 0.05)
    d = jstate.x_client.size
    errs = jnp.zeros((M, d)).at[idx].add(jdelta)
    sel_vals, sidx, rx = jst.client_uplink_sparse(js.comp, None, d, key,
                                                  errs[idx], jnp.arange(N))
    errs = jst.ef_update_sparse(errs, jnp.asarray(idx), sidx, sel_vals, rx)

    delta = torch.from_numpy(np.array(jdelta))
    vals, tidx = client_uplink_sparse(ts.comp, tstate.errors,
                                      torch.from_numpy(idx), delta,
                                      ts._ingest_block)
    np.testing.assert_array_equal(tstate.errors.numpy(), np.asarray(errs))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(sel_vals))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(sidx))

    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tdelta, _ = ts._train_block(tstate.x_client, tb, 0.05)
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta),
                               atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("model", ["mlp", "convmixer"])
@pytest.mark.parametrize("comp,wire", [("blocktopk", False),
                                       ("blocktopk", True), ("sign", False),
                                       ("sign", True)])
def test_round0_dense_uplink_given_the_same_deltas(model, comp, wire):
    """Round 0 of the dense uplink from the JAX side's deltas, in memory
    (the topk_ef / sign_ef twins, in place on the (m, d) buffer) and over
    the packed wire (the pack/unpack twins): hats and EF rows bitwise for
    blocktopk; for sign the scale within SIGN_ULP ulp, the signs equal, and
    the EF rows ``tot − hat`` of the port's own hat."""
    defs, jloss, data = make_problem(model, M)
    kw = _cfg("b", compressor=comp, sparse_uplink=False, wire=wire,
              wire_pack_impl="pallas")
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss(model), FedConfig(**kw), device="cpu")
    p0 = staged_init(defs)
    jstate = js.init(p0)
    tstate = ts.init(params_from_jax(jax.device_get(p0)))
    idx, b, key = _staged_rounds(data, 1)[0]
    jdelta, _ = js._train_block(js.unravel(jstate.x_client), jstate.x_client,
                                jax.tree.map(jnp.asarray, b), key, 0.05)
    d = jstate.x_client.size
    r = np.random.default_rng(2)     # a nonzero carried error
    errs0 = (r.normal(size=(M, d)) * 1e-3).astype(np.float32)
    jhat, jerr = jst.client_uplink(js.comp, js.codec, d, key, jdelta,
                                   jnp.asarray(errs0[idx]), jnp.arange(N))
    errors = torch.from_numpy(errs0.copy())
    hat = client_uplink(ts.comp, ts.codec, d, torch.from_numpy(
        np.array(jdelta)), errors, torch.from_numpy(idx))
    jhat, jerr = np.asarray(jhat), np.asarray(jerr)
    rest = np.setdiff1d(np.arange(M), idx)
    np.testing.assert_array_equal(errors.numpy()[rest], errs0[rest])
    if comp == "blocktopk":
        np.testing.assert_array_equal(hat.numpy(), jhat)
        np.testing.assert_array_equal(errors.numpy()[idx], jerr)
        return
    tot = np.array(jdelta) + errs0[idx]
    for i in range(N):
        scale, jscale = np.abs(hat[i].numpy()).max(), np.abs(jhat[i]).max()
        assert _ulps(scale, jscale) <= SIGN_ULP
        np.testing.assert_array_equal(np.sign(hat[i].numpy()),
                                      np.sign(jhat[i]))
    np.testing.assert_array_equal(errors.numpy()[idx], tot - hat.numpy())


@pytest.mark.parametrize("kw", [
    dict(compressor="topk"),                          # global top-k uplink
    dict(algorithm="fedams", compressor="none"),      # uncompressed
    dict(algorithm="fedadam", eta=0.03, eps=1e-3),
    dict(server_state_dtype="bfloat16", track_gamma=False),   # fused, jnp
    dict(server_state_dtype="int8", track_gamma=False, fused_ingest="off"),
    dict(local_opt="sgdm", eta_l_decay=0.9, option=2),
])
def test_fedsim_variants_track_jax(kw):
    """Other configs of the slice's round on the MLP: global top-k, the
    uncompressed algorithms, quantized server state on the fused and the
    two-pass route, another local rule and LR schedule. 5 rounds."""
    hist, jflat, tstate, _ = _run_both("mlp", _cfg("b", **kw), rounds=5)
    np.testing.assert_allclose(hist[:, 1], hist[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tstate.params.numpy(), jflat, atol=1e-4)


def test_fused_ingest_resolves_like_the_jax_fedsim_on_cpu():
    loss = _port_loss("mlp")
    auto = FedSim(loss, FedConfig(**_cfg("b", track_gamma=False)),
                  device="cpu")
    assert auto._fused == "jnp"            # auto takes the kernel only on CUDA
    forced = FedSim(loss, FedConfig(**_cfg("a")), device="cpu")
    assert forced._fused == "kernel"       # dispatches to the twin on CPU
    assert FedSim(loss, FedConfig(**_cfg("b")), device="cpu")._fused == "off"
    with pytest.raises(ValueError, match="cannot fuse"):
        FedSim(loss, FedConfig(**_cfg("b", fused_ingest="kernel")),
               device="cpu")


def test_run_rounds_equals_round_loop_and_refuses_repeated_ids():
    defs, _, data = make_problem("mlp", M)
    p0 = params_from_jax(jax.device_get(staged_init(defs)))
    staged = _staged_rounds(data, 3)
    sims = [FedSim(_port_loss("mlp"), FedConfig(**_cfg("a")), device="cpu")
            for _ in range(2)]
    s0 = sims[0].init(p0)
    for idx, b, _ in staged:
        s0, _ = sims[0].round(s0, b, idx)
    s1, mets = sims[1].run_rounds(
        sims[1].init(p0),
        {k: np.stack([b[k] for _, b, _ in staged]) for k in ("x", "y")},
        np.stack([idx for idx, _, _ in staged]))
    assert len(mets) == 3 and s1.round == 3 and s1.bits == s0.bits
    assert torch.equal(s0.params, s1.params)
    assert torch.equal(s0.errors, s1.errors)
    with pytest.raises(ValueError, match="distinct"):
        sims[0].round(s0, staged[0][1], np.array([1, 1, 2, 3]))
