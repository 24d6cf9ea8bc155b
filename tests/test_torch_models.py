"""The port's model zoo (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package, on the CPU at smoke size.

Every input is drawn from a numpy seed; JAX params come from the JAX init
and are carried across by ``convert.model_params_from_jax``. Each
tolerance is stated where it is set: fp32 throughout, so the two sides
differ only in the order XLA and PyTorch sum their reductions and
matmuls.

* Configs: every field of all ten ``ModelConfig``s (full and smoke) and
  of their ``ArchSpec``s, ``num_params``, ``layer_kinds``,
  ``layer_windows`` and ``plan_stack``; the defs trees (shapes, specs,
  inits) and the ravel order.
* Layers: each function of ``models/layers.py``.
* Attention: ``attention_core`` causal, windowed, softcapped and
  bidirectional, unchunked and q-chunked (``chunk=8``, so windowed layers
  slice a band); the prefill cache roll, bitwise.
* Model: ``Model.loss`` and its gradient against ``jax.grad`` on the six
  attention-only smoke configs and on ``test_decode_consistency.py``'s
  ``dense_gqa`` and ``local_global_softcap``; the three remat policies.
* Refusals: MoE, MLA, MTP, RG-LRU, xLSTM, tp > 1 and seq-sharded decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import base as jbase
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import get_arch as jax_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import stack as jstack
from repro.models.model import Model as JaxModel
from repro.sharding.rules import ParallelContext as JaxCtx
from repro.sharding.rules import attn_dims as jattn_dims
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.convert import model_params_from_jax, model_params_to_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import stack as tstack
from repro_torch.models.model import Model
from repro_torch.models.params import leaves_with_paths, ravel, tree_map
from repro_torch.sharding.rules import ParallelContext
from test_decode_consistency import CASES as DECODE_CASES

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()
#: the archs the port builds (every layer "attn", a dense FFN, no MLA/MTP)
PORTED = ("gemma2-2b", "gemma2-27b", "qwen1.5-32b", "deepseek-coder-33b",
          "internvl2-1b", "hubert-xlarge")
UNPORTED = {"deepseek-v3-671b": ("MoE", "MLA", "MTP"),
            "qwen2-moe-a2.7b": ("MoE",), "recurrentgemma-2b": ("RG-LRU",),
            "xlstm-350m": ("xLSTM",)}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, rel, what=""):
    """|got − want| ≤ rel · max|want| (+ a denormal floor)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * np.abs(want).max() + 1e-30, (what, err,
                                                      np.abs(want).max())


# -- configs ----------------------------------------------------------------


def test_config_classes_have_the_reference_fields_and_defaults():
    for name in ("MoEConfig", "MLAConfig", "RGLRUConfig", "XLSTMConfig",
                 "MTPConfig", "ModelConfig", "MeshConfig", "ShapeConfig",
                 "ExperimentConfig"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jbase, name))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tbase, name))]
        assert tf == jf, name
    assert {k: dataclasses.asdict(v) for k, v in
            tbase.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    mc = tbase.MeshConfig(shape=(4, 2))
    assert (mc.tp, mc.dp) == (2, 4)
    cfg = get_arch("gemma2-2b").smoke
    assert tbase.mreplace(cfg, num_layers=3).num_layers == 3
    with pytest.raises(ValueError, match="block_pattern must be non-empty"):
        tbase.ModelConfig(name="x", family="dense", num_layers=1, d_model=8,
                          num_heads=2, num_kv_heads=2, d_ff=8, vocab_size=8,
                          block_pattern=())


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("which", ["model", "smoke"])
def test_arch_configs_equal_the_reference(arch, which):
    assert ARCH_IDS == JAX_ARCH_IDS
    js, ts = jax_arch(arch), get_arch(arch)
    jc, tc = getattr(js, which), getattr(ts, which)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for f in ("client_mode", "long_500k", "has_decode", "notes"):
        assert getattr(ts, f) == getattr(js, f), f
    assert tc.num_params() == jc.num_params()
    assert tc.num_active_params() == jc.num_active_params()
    assert tc.layer_kinds == jc.layer_kinds
    assert tc.layer_windows == jc.layer_windows
    tg, tn, tt = tstack.plan_stack(tc)
    jg, jn, jt = jstack.plan_stack(jc)
    as_t = lambda ds: [(d.kind, d.window) for d in ds]
    assert (as_t(tg), tn, as_t(tt)) == (as_t(jg), jn, as_t(jt))


def _jax_spec(spec, ndim):
    s = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return s


@pytest.mark.parametrize("arch", PORTED)
def test_defs_and_ravel_order_equal_the_reference(arch):
    """The same defs tree (shapes, dtypes, inits, scales and per-dim
    specs, stacked group leaves included) and the same flat vector:
    ``ravel`` of the converted JAX init is ``ravel_pytree`` of it,
    bitwise — the layout of the mesh's EF rows and of checkpoints."""
    jm, tm = JaxModel(jax_arch(arch).smoke), Model(get_arch(arch).smoke)
    jdefs = dict(leaves_with_paths(jax.tree.map(
        lambda d: d, jm.defs(), is_leaf=jparams.is_def)))
    tdefs = list(leaves_with_paths(tm.defs()))
    assert [p for p, _ in tdefs] == sorted(jdefs)
    for path, d in tdefs:
        j = jdefs[path]
        assert (d.shape, d.dtype, d.init, d.scale) == (
            tuple(j.shape), j.dtype, j.init, j.scale), path
        assert d.dim_specs == _jax_spec(j.spec, len(j.shape)), path
    jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    flat, _ = ravel(model_params_from_jax(jp, "cpu"))
    want = np.asarray(ravel_pytree(jp)[0])
    assert np.array_equal(flat.numpy(), want)
    back = model_params_to_jax(model_params_from_jax(jp, "cpu"))
    assert all(np.array_equal(a, np.asarray(b)) for (_, a), (_, b) in zip(
        leaves_with_paths(back), leaves_with_paths(jp)))


def test_init_draws_every_kind_from_the_generator():
    cfg = get_arch("qwen1.5-32b").smoke
    m = Model(cfg)
    a = m.init(torch.Generator().manual_seed(3), "cpu")
    b = m.init(torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        [v for _, v in leaves_with_paths(a)],
        [v for _, v in leaves_with_paths(b)]))
    mix = a["stack"]["groups"]["l0"]["mix"]
    assert mix["wq"].shape == (2, cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert torch.equal(mix["bq"], torch.zeros_like(mix["bq"]))
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    assert abs(float(a["embed"]["table"].std()) - 1.0) < 0.05
    assert abs(float(mix["wq"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


# -- layers -------------------------------------------------------------------

R = np.random.default_rng(0)
X = R.normal(size=(2, 6, 32)).astype(np.float32)
S_ = R.normal(size=(32,)).astype(np.float32)


@pytest.mark.parametrize("name", ["rms_norm", "softcap", "silu", "gelu",
                                  "rope", "rope_theta"])
def test_elementwise_layers_match(name):
    """Within 1e-6 of the largest value (fp32; XLA and PyTorch round the
    mean, tanh, exp and cos/sin each in their own way)."""
    if name == "rms_norm":
        got = tlayers.rms_norm(t(S_), t(X), 1e-6)
        want = jlayers.rms_norm(jnp.asarray(S_), jnp.asarray(X), 1e-6)
    elif name == "softcap":
        got = tlayers.softcap(t(X) * 40, 30.0)
        want = jlayers.softcap(jnp.asarray(X) * 40, 30.0)
        assert tlayers.softcap(t(X), None) is not None
    elif name in ("silu", "gelu"):
        got = tlayers.activation(t(X) * 3, name)
        want = jlayers.activation(jnp.asarray(X) * 3, name)
    else:
        theta = 1e6 if name == "rope_theta" else 1e4
        x = X.reshape(2, 6, 2, 16)
        pos = np.arange(6, dtype=np.int32)[None] + np.array([[0], [37]])
        got = tlayers.rope(t(x), t(pos), theta)
        want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(got, want, 1e-6, name)


@pytest.mark.parametrize("gated,act", [(True, "gelu"), (True, "silu"),
                                       (False, "gelu")])
def test_ffn_matches(gated, act):
    d, ff = 32, 48
    w = {k: R.normal(size=s).astype(np.float32) * 0.2 for k, s in (
        ("up", (d, ff)), ("down", (ff, d)), ("gate", (d, ff)))}
    if not gated:
        del w["gate"]
    defs = tlayers.ffn_defs(d, ff, act, gated)
    assert sorted(defs) == sorted(w)
    got = tlayers.ffn_apply({k: t(v) for k, v in w.items()}, t(X), CTX,
                            act=act, dtype="float32")
    want = jlayers.ffn_apply({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(X), JCTX, act=act, dtype="float32")
    close(got, want, 1e-6)


def test_embed_unembed_and_xent_match():
    V, d = 50, 32
    table = R.normal(size=(V, d)).astype(np.float32)
    toks = R.integers(0, V, size=(2, 6)).astype(np.int32)
    got = tlayers.embed_lookup({"table": t(table)}, t(toks), CTX, "float32")
    want = jlayers.embed_lookup({"table": jnp.asarray(table)},
                                jnp.asarray(toks), JCTX, "float32")
    assert np.array_equal(got.numpy(), np.asarray(want))
    out = R.integers(0, 80, size=(2, 6)).astype(np.int32)   # some >= V
    got = tlayers.embed_lookup({"table": t(table)}, t(out), CTX, "float32")
    want = jlayers.embed_lookup({"table": jnp.asarray(table)},
                                jnp.asarray(out), JCTX, "float32")
    assert np.array_equal(got.numpy(), np.asarray(want))
    close(tlayers.unembed_logits({"table": t(table)}, t(X), "float32"),
          jlayers.unembed_logits({"table": jnp.asarray(table)},
                                 jnp.asarray(X), "float32"), 1e-6)
    logits = (R.normal(size=(2, 6, V)) * 5).astype(np.float32)
    labels = R.integers(0, 40, size=(2, 6)).astype(np.int32)
    mask = (R.random((2, 6)) < 0.6).astype(np.float32)
    for tv, mk in ((None, None), (40, None), (40, mask), (V, None)):
        got = tlayers.sharded_xent(t(logits), t(labels), CTX, true_vocab=tv,
                                   mask=None if mk is None else t(mk))
        want = jlayers.sharded_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    JCTX, true_vocab=tv,
                                    mask=None if mk is None
                                    else jnp.asarray(mk))
        close(got, want, 1e-6, f"xent true_vocab={tv}")


# -- attention ---------------------------------------------------------------


def _qkv(B=2, Sq=32, Sk=32, H=4, hd=16, seed=1):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, s, H, hd)).astype(np.float32)
            for s in (Sq, Sk, Sk)]


@pytest.mark.parametrize("chunk", [2048, 8])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, None), (True, 12, None), (True, 12, 5.0), (True, 0, 5.0),
    (False, 0, None), (True, 3, None)])
def test_attention_core_matches(causal, window, cap, chunk):
    """``attention_core`` within 1e-6 of the largest output (fp32). At
    ``chunk=8`` (Sq = 32 > 2·chunk) the chunked path runs; a window of 12
    gives a band of 24 < 32 keys, so the band's start moves and clamps.
    The port's chunked and unchunked outputs also agree within 1e-6: a
    masked key adds exactly 0."""
    q, k, v = _qkv()
    kw = dict(causal=causal, window=window, cap=cap)
    got = tattn.attention_core(t(q), t(k), t(v), chunk=chunk, **kw)
    want = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), chunk=chunk, **kw)
    close(got, want, 1e-6)
    whole = tattn.attention_core(t(q), t(k), t(v), chunk=2048, **kw)
    close(got, whole.numpy(), 1e-6, "chunked vs unchunked")


def test_attention_core_refuses_a_ragged_chunking():
    q, k, v = _qkv(Sq=36, Sk=36)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tattn.attention_core(t(q), t(k), t(v), causal=True, window=0,
                             cap=None, chunk=8)


@pytest.mark.parametrize("heads,kv,tp", [(4, 2, 1), (4, 4, 1), (8, 1, 1),
                                         (6, 4, 1)])
def test_expand_kv_matches(heads, kv, tp):
    dims = jattn_dims(heads, kv, 8, tp)
    k = np.random.default_rng(2).normal(
        size=(2, 5, dims.kv_local, 8)).astype(np.float32)
    from repro_torch.sharding.rules import attn_dims
    got = tattn.expand_kv(t(k), attn_dims(heads, kv, 8, tp), CTX)
    want = jattn.expand_kv(jnp.asarray(k), dims, JCTX)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,C", [(20, 16), (16, 16), (37, 16), (10, 16),
                                 (40, 40)])
def test_prefill_cache_roll_is_bitwise(monkeypatch, S, C):
    """``attn_train``'s prefill cache: the last C keys rolled so slot j
    holds position p with p % C == j (zero-padded when S < C). With RoPE
    patched to the identity on both sides and small-integer inputs and
    weights the projections are exact, so the caches must be equal to the
    bit."""
    monkeypatch.setattr(jattn, "rope", lambda x, pos, theta: x)
    monkeypatch.setattr(tattn, "rope", lambda x, pos, theta: x)
    r = np.random.default_rng(S)
    d = 16
    dims = jattn_dims(4, 2, 8, 1)
    from repro_torch.sharding.rules import attn_dims
    p = {k: r.integers(-2, 3, size=s).astype(np.float32) for k, s in (
        ("wq", (d, 32)), ("wk", (d, 16)), ("wv", (d, 16)), ("wo", (32, d)))}
    x = r.integers(-2, 3, size=(2, S, d)).astype(np.float32)
    kw = dict(causal=True, window=C, cap=None, rope_theta=1e4,
              dtype="float32", return_cache_len=C)
    _, (tk, tv) = tattn.attn_train({k: t(v) for k, v in p.items()}, t(x),
                                   attn_dims(4, 2, 8, 1), CTX, **kw)
    _, (jk, jv) = jattn.attn_train({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), dims, JCTX, **kw)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


# -- the model ---------------------------------------------------------------

MODEL_CASES = {a: (jax_arch(a).smoke, get_arch(a).smoke) for a in PORTED}
MODEL_CASES.update({f"decode:{n}": (c, tbase.ModelConfig(**{
    f.name: getattr(c, f.name) for f in dataclasses.fields(c)}))
    for n, c in DECODE_CASES.items()
    if n in ("dense_gqa", "local_global_softcap")})


def _batch(cfg, B, S, seed):
    r = np.random.default_rng(seed)
    labels = r.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.frontend is not None:
        x = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return {"embeddings": x, "labels": labels}
    return {"tokens": r.integers(0, cfg.vocab_size, size=(B, S)).astype(
        np.int32), "labels": labels}


def _jax_and_port(name, seed=0):
    jc, tc = MODEL_CASES[name]
    jm, tm = JaxModel(jc), Model(tc)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, jp, model_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_loss_and_gradient_match_jax(name):
    """``Model.loss`` within 1e-6 relative and every leaf of its gradient
    within 2e-5 of the leaf's largest |∂| (``jax.grad``), at S = 32 with
    ``chunk=8``: the chunked path, and a band on the windowed layers (16 +
    8 < 32)."""
    jm, tm, jp, tp = _jax_and_port(name)
    cfg = tm.cfg
    b = _batch(cfg, 2, 32, 5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss = lambda p: jm.loss(p, jb, JCTX, remat_policy="none", chunk=8)[0]
    want, jg = jax.value_and_grad(jloss)(jp)
    params = tree_map(lambda x: x.clone().requires_grad_(True), tp)
    loss, met = tm.loss(params, {k: t(v) for k, v in b.items()}, CTX,
                        remat_policy="none", chunk=8)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    assert float(met["aux"]) == 0.0
    jgd = dict(leaves_with_paths(jax.device_get(jg)))
    for path, leaf in leaves_with_paths(params):
        g = (leaf.grad if leaf.grad is not None
             else torch.zeros_like(leaf))     # an unused table: JAX's zeros
        close(g, jgd[path], 2e-5, f"{name} grad {path}")


@pytest.mark.parametrize("name", ["gemma2-2b", "hubert-xlarge"])
def test_remat_policies_give_the_same_numbers(name):
    """"none", "full" (torch.utils.checkpoint per group) and "dots" (the
    matmul outputs saved): the same loss and gradient to the bit."""
    _, tm, _, tp = _jax_and_port(name)
    b = {k: t(v) for k, v in _batch(tm.cfg, 2, 16, 9).items()}
    out = {}
    for policy in ("none", "full", "dots"):
        params = tree_map(lambda x: x.clone().requires_grad_(True), tp)
        loss, _ = tm.loss(params, b, CTX, remat_policy=policy)
        loss.backward()
        out[policy] = [loss.detach()] + [
            leaf.grad if leaf.grad is not None else torch.zeros(())
            for _, leaf in leaves_with_paths(params)]
    for policy in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out[policy],
                                                     out["none"])), policy


def test_encode_matches_jax():
    jm, tm, jp, tp = _jax_and_port("hubert-xlarge")
    b = _batch(tm.cfg, 2, 12, 3)
    want = jm.encode(jp, {k: jnp.asarray(v) for k, v in b.items()}, JCTX)
    with torch.no_grad():
        got = tm.encode(tp, {k: t(v) for k, v in b.items()}, CTX)
    close(got, want, 1e-5)


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("arch", list(UNPORTED))
def test_unported_configs_are_refused_by_name(arch):
    for cfg in (get_arch(arch).smoke, get_arch(arch).model):
        with pytest.raises(NotImplementedError) as e:
            Model(cfg)
        for what in UNPORTED[arch]:
            assert what in str(e.value), (arch, what, str(e.value))
        assert "ROADMAP Queue 1 item 8" in str(e.value)


def test_tp_and_seq_sharded_decode_are_refused():
    cfg = get_arch("gemma2-2b").smoke
    with pytest.raises(NotImplementedError, match="tp = 1"):
        Model(cfg, tp=2)
    m = Model(cfg)
    with pytest.raises(NotImplementedError, match="sequence-sharded"):
        m.cache_defs(2, 32, seq_sharded=True)
    seq = ParallelContext(seq_axis="data")
    with pytest.raises(NotImplementedError, match="sequence-sharded"):
        tattn.attn_decode({}, torch.zeros(1, 1, 8), tattn.KVCache(
            torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8)), 0, m.dims,
            seq, window=0, cap=None, rope_theta=1e4, total_len=4)
    enc = Model(get_arch("hubert-xlarge").smoke)
    with pytest.raises(ValueError, match="encoder-only"):
        enc.prefill({}, torch.zeros(1, 4, dtype=torch.int32), CTX,
                    max_len=8)
