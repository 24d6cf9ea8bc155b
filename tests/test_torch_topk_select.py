"""The CUDA top-k kernels' selection (``csrc/topk_select.cuh``: a radix
select of the k-th magnitude, then ties at it by index), mirrored with
tensor ops in ``kernels/ref.py::threshold_select``, against the stable-sort
twins and the Pallas ``topk_ef_sparse``/``topk_ef`` kernels (interpret
mode), on inputs built to trip a threshold select: magnitudes that differ
only in the last radix digit, all-equal magnitudes, more ties at the
threshold than are kept, NaNs of several payloads beside ±inf, ±0.0 and
denormals, and a ragged last block. All bitwise, NaN payloads included.

XLA:CPU reads a denormal operand of the Pallas kernels' ``x + e`` as a
zero of its sign; the port keeps IEEE denormals, on the card too (ROADMAP
Queue 3). So the twins meet Pallas on inputs with the denormals flushed,
and ``test_pallas_flushes_denormal_totals`` shows the difference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.topk_ef import topk_ef as pallas_topk_ef
from repro.kernels.topk_ef import topk_ef_sparse as pallas_topk
from repro_torch.kernels import ref

torch.set_num_threads(1)

# 7 whole 2048-segments of hard cases and a 1,802-value tail, as the last
# block of ConvMixer-256-8 (d = 704,266)
D = 7 * 2048 + 1802
CASES = [(block, k) for block in (128, 384, 2048)
         for k in (1, 2, 31, 32, 33, 1024, block) if k <= block]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _eq(want, got, what):
    np.testing.assert_array_equal(_bits(want), _bits(got), err_msg=what)


def _flush_denormals(t):
    """A denormal becomes a zero of its sign, as XLA:CPU's add reads it."""
    b = t.numpy().view(np.uint32)
    return torch.from_numpy(np.where(b & 0x7F800000 == 0, b & 0x80000000,
                                     b).view(np.float32))


def _pallas(x, e, k, block):
    """Both Pallas kernels on each row, on the zero-padded blocks (as the
    compressor pads): ``(vals, idx, sparse EF, hat, dense EF)`` stacked."""
    nb = -(-x.shape[1] // block)
    xp = F.pad(x, (0, nb * block - x.shape[1])).numpy()
    ep = F.pad(e, (0, nb * block - x.shape[1])).numpy()
    outs = []
    for i in range(x.shape[0]):
        jx, je = jnp.asarray(xp[i]), jnp.asarray(ep[i])
        outs.append([np.asarray(a) for a in (
            *pallas_topk(jx, je, k=k, block=block),
            *pallas_topk_ef(jx, je, k=k, block=block))])
    return [np.stack(a) for a in zip(*outs)]


def _twins(x, e, k, block):
    e_s, e_d = e.clone(), e.clone()
    rows = torch.arange(x.shape[0])
    vals, idx = ref.topk_ef_sparse(x, e_s, rows, k=k, block=block)
    hat = ref.topk_ef(x, e_d, rows, k=k, block=block)
    return vals, idx, e_s, hat, e_d


@pytest.fixture(scope="module")
def hard():
    x = ref.topk_hard_cases(2, D, seed=3)
    return x, torch.full_like(x, -0.0)


@pytest.mark.parametrize("block,k", CASES)
def test_threshold_select_matches_twins_and_pallas(hard, block, k):
    x, e = hard
    c, d = x.shape
    nb = -(-d // block)
    tb = F.pad(x + e, (0, nb * block - d)).view(c, nb, block)
    keep, li, _ = ref.threshold_select(tb, k)
    assert bool((keep.sum(-1) == k).all())
    # the mirror's picks, in order, are the twins'
    vals, idx, e_s, hat, e_d = _twins(x, e, k, block)
    base = torch.arange(nb)[:, None] * block
    np.testing.assert_array_equal(idx.numpy(), (li + base).int().numpy())
    _eq(tb.gather(-1, li), vals, "mirror vals")
    _eq(tb.masked_fill(keep, 0.0).view(c, -1)[:, :d], e_s, "mirror EF")
    _eq(torch.where(keep, tb, 0.0).view(c, -1)[:, :d], hat, "mirror hat")
    # the twins are the Pallas kernels
    xf = _flush_denormals(x)
    vals, idx, e_s, hat, e_d = _twins(xf, e, k, block)
    jv, ji, je, jh, jde = _pallas(x, e, k, block)
    _eq(jv, vals, "vals")
    np.testing.assert_array_equal(ji, idx.numpy())
    _eq(je[:, :d], e_s, "EF (sparse)")
    _eq(jh[:, :d], hat, "hat")
    _eq(jde[:, :d], e_d, "EF (dense)")


def test_pallas_flushes_denormal_totals(hard):
    """The hard cases' sixth segment (±0.0 and denormals): the Pallas
    kernels read every denormal as a zero of its sign, the twins keep
    them and so pick the largest denormals."""
    x, e = hard
    seg = slice(5 * 2048, 6 * 2048)
    x, e = x[:, seg].contiguous(), e[:, seg].contiguous()
    jv, ji, je, jh, jde = _pallas(x, e, 32, 2048)
    vals, idx, e_s, hat, e_d = _twins(x, e, 32, 2048)
    assert not np.array_equal(ji, idx.numpy())
    assert int((_bits(jde) & 0x7F800000 == 0).sum()) == \
        int((_bits(jde) & 0x7FFFFFFF == 0).sum())      # no denormal left
    assert int(((_bits(e_d.numpy()) & 0x7F800000 == 0)
                & (_bits(e_d.numpy()) & 0x7FFFFF != 0)).sum()) > 1000
    vals, idx, e_s, hat, e_d = _twins(_flush_denormals(x), e, 32, 2048)
    np.testing.assert_array_equal(ji, idx.numpy())
    _eq(jde, e_d, "EF (dense)")


@pytest.mark.parametrize("k", [1, 3, 6])
def test_twin_orders_nans_by_payload_as_pallas(k):
    """NaN magnitudes above +inf, ordered by their payload bits and then by
    index, as XLA's top_k orders them (a stable sort of the float |v| would
    order NaNs by index alone)."""
    x = np.zeros(256, np.float32)
    b = x.view(np.uint32)
    b[[5, 9, 100, 130, 140]] = [0x7FC00000, 0x7FFFFFFF, 0xFFC00001,
                                0x7FC00000, 0x7FC00000]
    b[[7, 150]] = [0x7F800000, 0xFF800000]
    x[50] = 3.0
    e = np.zeros(256, np.float32)
    jv, ji, je = pallas_topk(jnp.asarray(x), jnp.asarray(e), k=k, block=128)
    err = torch.from_numpy(e)[None].clone()
    tv, ti = ref.topk_ef_sparse(torch.from_numpy(x)[None], err,
                                torch.tensor([0]), k=k, block=128)
    np.testing.assert_array_equal(np.asarray(ji), ti[0].numpy())
    _eq(jv, tv[0], "vals")
    _eq(je, err[0], "EF")
    assert ti[0, 0].tolist()[:min(k, 3)] == [9, 100, 5][:k]
    assert ti[0, 1].tolist()[:min(k, 4)] == [130, 140, 150, 128][:k]
    tb = torch.from_numpy(x).view(2, 128)
    _, li, _ = ref.threshold_select(tb, k)
    np.testing.assert_array_equal(
        (li + torch.tensor([0, 128])[:, None]).int().numpy(), ti[0].numpy())


def test_threshold_select_stops_once_the_kth_bin_is_taken_whole():
    """Distinct magnitudes whose k-th value is alone in its exponent bin
    take one digit pass; equal magnitudes take all four and fall to the tie
    rank."""
    t = torch.tensor([[4.0, -8.0, 1.5, 1.25, 0.5, -0.25, 0.1, 0.0]])
    keep, li, passes = ref.threshold_select(t, 2)
    assert passes.tolist() == [1] and li.tolist() == [[1, 0]]
    keep, li, passes = ref.threshold_select(torch.full((1, 8), -0.5), 3)
    assert passes.tolist() == [4] and li.tolist() == [[0, 1, 2]]
    assert keep.tolist() == [[True] * 3 + [False] * 5]
