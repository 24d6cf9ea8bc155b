"""The top-k compressors against ``repro.core.compressors``, bitwise:
``select`` and ``compress`` for topk and blocktopk, on ties, at k = 1, and
with a padded last block; randk on the positions the JAX compressor draws.
The dense compressors (sign, int8, identity) are held in
tests/test_torch_dense_uplink.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressors import block_layout as jax_block_layout
from repro.core.compressors import make_compressor as jax_make
from repro.core.compressors import selection_to_dense as jax_to_dense
from repro_torch.core.compressors import (Selection, block_layout,
                                          make_compressor, selection_to_dense)

torch.set_num_threads(1)


def _vec(kind, d, seed):
    r = np.random.default_rng(seed)
    if kind == "ties":
        return (r.integers(-3, 4, size=d) * 0.25).astype(np.float32)
    if kind == "zeros":
        return np.zeros(d, np.float32)
    return r.normal(size=d).astype(np.float32)


CASES = [
    # (compressor, ratio, block, d)
    ("topk", 1 / 64, 2048, 5000),
    ("topk", 1 / 4, 2048, 37),
    ("topk", 1 / 1000, 2048, 900),       # k = 1: the argmax path
    ("blocktopk", 1 / 64, 2048, 6922),   # ragged last block
    ("blocktopk", 1 / 64, 2048, 4096),   # no padding
    ("blocktopk", 1 / 128, 256, 1000),   # k = 2, ragged
    ("blocktopk", 1 / 256, 256, 1000),   # k = 1 per block, ragged
    ("blocktopk", 1 / 8, 2048, 300),     # block clamped to 384
]


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("name,ratio,block,d", CASES)
def test_select_and_compress_match_jax_bitwise(name, ratio, block, d, kind):
    x = _vec(kind, d, d)
    jc, tc = jax_make(name, ratio, block), make_compressor(name, ratio, block)
    assert tc.name == jc.name
    assert tc.bits_per_message(d) == jc.bits_per_message(d)
    assert tc.q_bound(None) == jc.q_bound(None)
    js, ts = jc.select(jnp.asarray(x)), tc.select(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(js.idx), ts.idx.numpy())
    np.testing.assert_array_equal(np.asarray(js.vals), ts.vals.numpy())
    assert ts.idx.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jc.compress(jnp.asarray(x))),
                                  tc.compress(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_to_dense(js, d)),
        selection_to_dense(ts, d).numpy())


def test_padded_tail_can_be_selected_and_is_dropped():
    """A ragged last block holding fewer nonzeros than k: padded positions
    (index >= d) compete as zeros, carry 0.0, and are dropped densely."""
    d = 300                       # block 384: 84 padded positions
    x = np.zeros(d, np.float32)
    x[260:262] = [5.0, -4.0]
    c = make_compressor("blocktopk", 4 / 384, 2048)
    sel = c.select(torch.from_numpy(x))
    assert sel.idx.tolist() == [260, 261, 0, 1]
    x[:] = 0
    x[299] = 1.0
    sel = make_compressor("blocktopk", 4 / 384, 2048).select(
        torch.from_numpy(x))
    assert sel.idx.tolist() == [299, 0, 1, 2]
    sel = Selection(vals=torch.tensor([1.0, 0.0]),
                    idx=torch.tensor([299, 310], dtype=torch.int32))
    dense = selection_to_dense(sel, d)
    assert dense.shape == (d,) and float(dense[299]) == 1.0


@pytest.mark.parametrize("d,block", [(1, 2048), (127, 2048), (129, 2048),
                                     (704266, 2048), (5000, 256)])
def test_block_layout_matches(d, block):
    assert block_layout(d, block) == jax_block_layout(d, block)


def test_unknown_compressors_are_refused():
    with pytest.raises(ValueError, match="unknown"):
        make_compressor("topq")


def _jax_randk_draw(key, d, k):
    """The positions the JAX randk draws from ``key``."""
    return np.array(jax.random.permutation(key, d)[:k])


@pytest.mark.parametrize("ratio,d", [(1 / 64, 5000), (1 / 8, 37),
                                     (1 / 1000, 900), (1.0, 100)])
def test_randk_compress_is_bitwise_on_staged_positions(ratio, d):
    """Given the positions the JAX compressor draws from its key, the port's
    ``compress(x, idx)`` is the JAX ``compress(x, key)`` to the bit
    (NaN and -0.0 kept); name, bits and q_bound equal."""
    x = _nan_vec(d, d, 3)
    x[::7] = -0.0
    jc, tc = jax_make("randk", ratio), make_compressor("randk", ratio)
    assert tc.name == jc.name and tc.select is None
    assert tc.bits_per_message(d) == jc.bits_per_message(d)
    assert tc.q_bound(None) == jc.q_bound(None)
    k = max(1, int(round(ratio * d)))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jc.compress(jnp.asarray(x), key))
        got = tc.compress(torch.from_numpy(x), torch.from_numpy(
            _jax_randk_draw(key, d, k)).long()).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_randk_ef_compress_takes_the_draws_where_jax_takes_keys():
    """``ef_compress`` on (c, d) rows with randk: the JAX function on one
    row and the key the FedSim round hands it, the port's on the positions
    drawn from that key — the leaf key ``fold_in(key, 0)`` — bitwise."""
    from repro.core.error_feedback import ef_compress as jax_ef
    from repro_torch.core.error_feedback import ef_compress
    d, c, ratio = 3000, 3, 1 / 32
    r = np.random.default_rng(0)
    delta = r.standard_normal((c, d)).astype(np.float32)
    err = r.standard_normal((c, d)).astype(np.float32) * 0.1
    k = max(1, int(round(ratio * d)))
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(c)]
    draws = torch.from_numpy(np.stack([_jax_randk_draw(
        jax.random.fold_in(key, 0), d, k) for key in keys])).long()
    hat, new_err = ef_compress(make_compressor("randk", ratio),
                               torch.from_numpy(delta), torch.from_numpy(err),
                               draws)
    for i, key in enumerate(keys):
        jh, je = jax_ef(jax_make("randk", ratio), jnp.asarray(delta[i]),
                        jnp.asarray(err[i]), key)
        np.testing.assert_array_equal(hat[i].numpy(), np.asarray(jh))
        np.testing.assert_array_equal(new_err[i].numpy(), np.asarray(je))


def test_randk_positions_are_distinct_and_follow_the_generator():
    """``randk_positions``: (count, k) distinct positions of [0, d) a row,
    the same for equally seeded generators, and a generator is required."""
    from repro_torch.core.compressors import randk_positions
    a = randk_positions(torch.Generator().manual_seed(3), 1000, 40, 6, "cpu")
    b = randk_positions(torch.Generator().manual_seed(3), 1000, 40, 6, "cpu")
    assert a.shape == (6, 40) and torch.equal(a, b)
    assert all(row.unique().numel() == 40 for row in a)
    assert 0 <= int(a.min()) and int(a.max()) < 1000
    with pytest.raises(ValueError, match="torch.Generator"):
        randk_positions(None, 1000, 40, 6, "cpu")


NAN_PAYLOADS = (0x7FC00000, 0x7FFFFFFF, 0xFFC00001)


def _nan_vec(d, seed, n_nan):
    """Normal values (no denormals) with ``n_nan`` NaNs of the three
    payloads above at random positions, beside a few ±inf."""
    r = np.random.default_rng(seed)
    x = r.normal(size=d).astype(np.float32)
    bits = x.view(np.uint32)
    pick = r.permutation(d)
    bits[pick[:n_nan]] = r.choice(np.array(NAN_PAYLOADS, np.uint32), n_nan)
    bits[pick[n_nan:n_nan + 2]] = [0x7F800000, 0xFF800000]
    return x


@pytest.mark.parametrize("name,ratio,block,d,n_nan", [
    ("topk", 1 / 64, 2048, 5000, 40),       # k = 78: lax.top_k
    ("topk", 1 / 64, 2048, 5000, 200),      # more NaNs than k
    ("topk", 1 / 1000, 2048, 900, 6),       # k = 1: select by argmax
    ("blocktopk", 1 / 64, 2048, 6922, 60),  # k = 32 per block, ragged
    ("blocktopk", 1 / 256, 256, 1000, 12),  # k = 1 per block
    ("blocktopk", 1 / 128, 256, 1000, 30),  # k = 2 per block
])
def test_nans_order_as_the_jax_path_does(name, ratio, block, d, n_nan):
    """Where the JAX compressor calls ``lax.top_k`` (``compress``, and
    ``select`` at k > 1) NaNs order by payload; where it calls
    ``_argmax_select`` (``select`` at k = 1) the first NaN wins. The port
    follows each: equal indices and bitwise-equal values."""
    x = _nan_vec(d, d + n_nan, n_nan)
    jc, tc = jax_make(name, ratio, block), make_compressor(name, ratio, block)
    js, ts = jc.select(jnp.asarray(x)), tc.select(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(js.idx), ts.idx.numpy())
    np.testing.assert_array_equal(np.asarray(js.vals).view(np.uint32),
                                  ts.vals.numpy().view(np.uint32))
    jd = np.asarray(jc.compress(jnp.asarray(x)))
    td = tc.compress(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(jd.view(np.uint32), td.view(np.uint32))
    assert np.isnan(td).sum() == np.isnan(jd).sum() > 0
