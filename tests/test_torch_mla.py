"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against ``repro.models.mla``, on the CPU at smoke size.

Params and inputs are drawn with numpy from a seed. Each tolerance is
stated where it is set: in fp32 the two sides differ only in the order XLA
and PyTorch sum their matmuls and einsums; in bf16 also in where each
product rounds.

* ``mla_train`` in one chunk and in four (``chunk=8``), fp32 and bf16,
  fp32 activations on bf16 weights (JAX's promotion), and its gradient
  (params and input) against ``jax.grad``;
* the prefill cache (``_pack_cache``) at S < C, S = C and S > C, bitwise;
* ``mla_decode`` (absorbed) against the JAX function, before and after the
  ring wraps, and against the decompressed forward;
* the cache write copies the layer's cache alone;
* a length the chunks do not tile is refused, as the reference refuses it;
* the sequence-sharded decode branch on one shard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as JaxMLA
from repro.models import mla as jmla
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch.configs.base import MLAConfig
from repro_torch.models import mla as tmla
from repro_torch.models.params import leaves_with_paths
from repro_torch.sharding.rules import ParallelContext

torch.set_num_threads(1)

CTX, JCTX = ParallelContext(), JaxCtx()
DIMS = dict(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
            nope_head_dim=32, v_head_dim=32)
M, JM = MLAConfig(**DIMS), JaxMLA(**DIMS)
D, H = 64, 4


def _params(seed=0):
    """numpy params of ``mla_defs`` (norm scales drawn too, so that they
    matter)."""
    r = np.random.default_rng(seed)
    out = {}
    for path, d in leaves_with_paths(tmla.mla_defs(D, H, M, 1)):
        scale = d.scale if d.init == "normal" else 0.2
        a = r.normal(size=d.shape) * scale
        out[path[-1]] = (a + (1.0 if d.init == "ones" else 0.0)).astype(
            np.float32)
    return out


def _x(B, S, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def close(got, want, rel, what=""):
    """|got − want| ≤ rel · max|want|."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, dtype=np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _t(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def _j(p, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in p.items()}


def test_defs_equal_the_reference():
    jd = jmla.mla_defs(D, H, JM, 1)
    td = tmla.mla_defs(D, H, M, 1)
    assert sorted(jd) == sorted(td) == sorted(_params())
    for k in td:
        assert (td[k].shape, td[k].init, td[k].scale) == (
            tuple(jd[k].shape), jd[k].init, jd[k].scale), k


#: (compute dtype, activations' dtype, tolerance). fp32: 1e-5 of the
#: largest |out| (summation order). bf16 throughout: both sides round each
#: product to bf16 after an fp32 sum, so an output may differ by a bf16
#: ulp (2^-8 relative: 4e-3; measured 9.5e-6). fp32 activations on bf16
#: weights promote to fp32 on both sides (the weights' rounding is the
#: same), so 1e-5
DTYPES = [("float32", "float32", 1e-5), ("bfloat16", "bfloat16", 4e-3),
          ("bfloat16", "float32", 1e-5)]


@pytest.mark.parametrize("chunk", [2048, 8])
@pytest.mark.parametrize("dtype,act,tol", DTYPES)
def test_mla_train_matches_jax(dtype, act, tol, chunk):
    """A causal forward at S = 32: one chunk, or four of 8 (the q-chunk
    loop the reference scans), with its prefill cache."""
    p, x = _params(), _x(2, 32)
    kw = dict(rope_theta=1e4, cap=None, dtype=dtype, chunk=chunk,
              return_cache_len=40)
    want, jc = jmla.mla_train(_j(p), jnp.asarray(x).astype(act), JM, JCTX,
                              **kw)
    got, tc = tmla.mla_train(_t(p), torch.from_numpy(x).to(getattr(
        torch, act)), M, CTX, **kw)
    assert got.dtype == getattr(torch, str(want.dtype))
    close(got, want, tol, "out")
    close(tc.c_kv, jc.c_kv, tol, "c_kv")
    close(tc.k_rope, jc.k_rope, tol, "k_rope")


def test_mla_train_softcap_matches_jax():
    p, x = _params(3), _x(2, 24, 4)
    kw = dict(rope_theta=1e4, cap=5.0, dtype="float32", chunk=8)
    close(tmla.mla_train(_t(p), torch.from_numpy(x), M, CTX, **kw),
          jmla.mla_train(_j(p), jnp.asarray(x), JM, JCTX, **kw), 1e-5)


def test_mla_train_gradient_matches_jax():
    """∂ Σ out·R for every param and the input, four chunks, fp32: each
    within 2e-5 of its largest |∂| (``jax.grad``)."""
    p, x = _params(5), _x(2, 32, 6)
    R = np.random.default_rng(7).normal(size=(2, 32, D)).astype(np.float32)
    kw = dict(rope_theta=1e4, cap=None, dtype="float32", chunk=8)

    def jloss(pp, xx):
        return jnp.sum(jmla.mla_train(pp, xx, JM, JCTX, **kw) * R)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (tmla.mla_train(tp, tx, M, CTX, **kw) * torch.from_numpy(R)).sum(
    ).backward()
    close(tx.grad, jgx, 2e-5, "x")
    for k in tp:
        close(tp[k].grad, jgp[k], 2e-5, k)


@pytest.mark.parametrize("S,C", [(10, 16), (16, 16), (20, 16), (37, 16),
                                 (5, 1)])
def test_pack_cache_is_bitwise(S, C):
    a = np.random.default_rng(S).normal(size=(2, S, 3)).astype(np.float32)
    got = tmla._pack_cache(torch.from_numpy(a), C)
    want = jmla._pack_cache(jnp.asarray(a), C)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos", [0, 5, 15, 16, 29])
def test_mla_decode_matches_jax(pos):
    """One absorbed decode step against a random latent cache of C = 16
    slots: before the ring is full (the empty slots masked), at its last
    slot and after it wraps. Output and the new latents within 1e-5 of
    their largest |value|; every other slot of the cache as it was, to the
    bit."""
    r = np.random.default_rng(pos)
    p = _params(pos + 1)
    x = r.normal(size=(2, 1, D)).astype(np.float32)
    ckv = r.normal(size=(2, 16, DIMS["kv_lora_rank"])).astype(np.float32)
    kr = r.normal(size=(2, 16, DIMS["rope_head_dim"])).astype(np.float32)
    kw = dict(rope_theta=1e4, total_len=16, cap=None, dtype="float32")
    want, jc = jmla.mla_decode(_j(p), jnp.asarray(x), jmla.MLACache(
        jnp.asarray(ckv), jnp.asarray(kr)), jnp.int32(pos), JM, JCTX, **kw)
    got, tc = tmla.mla_decode(_t(p), torch.from_numpy(x), tmla.MLACache(
        torch.from_numpy(ckv), torch.from_numpy(kr)), pos, M, CTX, **kw)
    close(got, want, 1e-5)
    keep = [j for j in range(16) if j != pos % 16]
    for t_, j_, old in ((tc.c_kv, jc.c_kv, ckv), (tc.k_rope, jc.k_rope, kr)):
        close(t_, j_, 1e-5)
        assert np.array_equal(t_[:, keep].numpy(), old[:, keep])
        assert np.array_equal(np.asarray(j_)[:, keep], old[:, keep])


def test_absorbed_decode_equals_the_decompressed_forward():
    """Prefill 12 positions into a cache of 20, decode 8 more: each step's
    output within 1e-5 of the full-sequence forward's at that position
    (the absorption reassociates the forward's products, fp32)."""
    p, x = _t(_params(9)), torch.from_numpy(_x(2, 20, 10))
    kw = dict(rope_theta=1e4, cap=None, dtype="float32")
    with torch.no_grad():
        full = tmla.mla_train(p, x, M, CTX, **kw)
        _, cache = tmla.mla_train(p, x[:, :12], M, CTX, return_cache_len=20,
                                  **kw)
        for i in range(12, 20):
            out, cache = tmla.mla_decode(p, x[:, i:i + 1], cache, i, M, CTX,
                                         total_len=20, **kw)
            close(out[:, 0], full[:, i].numpy(), 1e-5, f"step {i}")


def test_decode_cache_write_copies_the_layer_alone():
    """A layer's cache that is a view of the stack's (n_groups, ...) cache:
    the new cache is the layer's size, and the stacked one is untouched."""
    r = np.random.default_rng(11)
    stacked = [torch.from_numpy(r.normal(size=(3, 2, 8, n)).astype(
        np.float32)) for n in (DIMS["kv_lora_rank"], DIMS["rope_head_dim"])]
    before = [c.clone() for c in stacked]
    x = torch.from_numpy(_x(2, 1, 12))
    cache = tmla.MLACache(stacked[0][1], stacked[1][1])
    _, new = tmla.mla_decode(_t(_params()), x, cache, 11, M, CTX,
                             rope_theta=1e4, total_len=8, dtype="float32")
    for c, old in zip(new, cache):
        assert c.untyped_storage().nbytes() == old.numel() * 4
        keep = [j for j in range(8) if j != 11 % 8]
        assert torch.equal(c[:, keep], old[:, keep])
    assert all(torch.equal(a, b) for a, b in zip(stacked, before))


def test_a_ragged_chunking_is_refused_as_the_reference_refuses_it():
    """S = 37 at chunk 16: two chunks of 18 leave one query over. The
    reference fails at its reshape; the port raises ValueError. S = 36
    runs on both."""
    p = _params()
    kw = dict(rope_theta=1e4, cap=None, dtype="float32", chunk=16)
    with pytest.raises(TypeError):
        jmla.mla_train(_j(p), jnp.asarray(_x(1, 37)), JM, JCTX, **kw)
    with pytest.raises(ValueError, match="not 2 chunks of 18"):
        tmla.mla_train(_t(p), torch.from_numpy(_x(1, 37)), M, CTX, **kw)
    close(tmla.mla_train(_t(p), torch.from_numpy(_x(1, 36)), M, CTX, **kw),
          jmla.mla_train(_j(p), jnp.asarray(_x(1, 36)), JM, JCTX, **kw),
          1e-5)


@pytest.mark.parametrize("pos", [5, 29])
def test_decode_over_a_one_shard_sequence_axis_matches_jax(pos):
    """The sequence-sharded branch (its slot offset and its log-sum-exp
    combine of the blocks' partial softmaxes) on one shard of the axis,
    in one process (every collective the identity), against the JAX
    decode: the output within 1e-5 and the written cache bitwise the
    unsharded port's. Over 4 gloo ranks it equals the unsharded decode:
    ``tests/test_torch_tp.py::test_seq_sharded_decode_equals_unsharded``."""
    r = np.random.default_rng(pos + 7)
    p = _params(pos)
    x = r.normal(size=(2, 1, D)).astype(np.float32)
    ckv = r.normal(size=(2, 16, DIMS["kv_lora_rank"])).astype(np.float32)
    kr = r.normal(size=(2, 16, DIMS["rope_head_dim"])).astype(np.float32)
    kw = dict(rope_theta=1e4, total_len=16, cap=None, dtype="float32")
    want, _ = jmla.mla_decode(_j(p), jnp.asarray(x), jmla.MLACache(
        jnp.asarray(ckv), jnp.asarray(kr)), jnp.int32(pos), JM, JCTX, **kw)
    cache = lambda: tmla.MLACache(torch.from_numpy(ckv), torch.from_numpy(kr))
    seq = ParallelContext(seq_axis="data")
    got, sc = tmla.mla_decode(_t(p), torch.from_numpy(x), cache(), pos, M,
                              seq, **kw)
    _, pc = tmla.mla_decode(_t(p), torch.from_numpy(x), cache(), pos, M, CTX,
                            **kw)
    close(got, want, 1e-5)
    assert torch.equal(sc.c_kv, pc.c_kv) and torch.equal(sc.k_rope,
                                                         pc.k_rope)
