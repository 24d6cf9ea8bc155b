"""The CUDA kernels against their plain twins, and the model zoo's smoke
configs against the CPU, on the card. Marked ``cuda``:
each test asks for the ``card`` fixture, which skips without CUDA (decided
at run time, never at import). Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

HP = dict(eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("d,block,k,ties", [
    (704266, 2048, 32, False), (704266, 2048, 1, False),
    (5000, 2048, 32, True), (1000, 384, 6, False), (300, 128, 1, True),
    (704266, 2048, 1024, False), (5000, 2048, 2048, True),
    (1000, 384, 384, False)])
def test_topk_ef_sparse_kernel_matches_twin(card, d, block, k, ties):
    g = torch.Generator(device=card).manual_seed(d + k)
    if ties:
        x = torch.randint(-2, 3, (3, d), generator=g, device=card).float()
        err = torch.zeros(7, d, device=card)
    else:
        x = torch.randn(3, d, generator=g, device=card)
        err = torch.randn(7, d, generator=g, device=card) * 0.3
    rows = torch.tensor([6, 0, 3], device=card)
    e_k, e_r = err.clone(), err.clone()
    vk, ik = ops.topk_ef_sparse(x, e_k, rows, k=k, block=block)
    vr, ir = ref.topk_ef_sparse(x, e_r, rows, k=k, block=block)
    torch.cuda.synchronize()
    assert torch.equal(vk, vr) and torch.equal(ik, ir)
    assert torch.equal(e_k, e_r)


def _same(a, b):
    """Bitwise equal, with NaN where the other has NaN (the payload of a
    NaN is not compared)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("option", [1, 2])
def test_fedams_ingest_kernel_matches_twin(card, dtype, option, nan):
    d, block, n, k = 5000, 2048, 4, 32
    nb = -(-d // block)
    g = torch.Generator(device=card).manual_seed(option)
    vals, idx = ref.topk_ef_sparse(
        torch.randn(n, d, generator=g, device=card),
        torch.zeros(n, d, device=card), torch.arange(n, device=card), k=k,
        block=block)
    if nan:   # a diverged client: NaN propagates into v-hat and int8 scales
        vals[1, 0, :3] = float("nan")
    x = torch.randn(d, generator=g, device=card)
    m = torch.randn(d, generator=g, device=card) * 1e-3
    if dtype == "int8":
        q = torch.randint(0, 128, (nb * block,), generator=g, device=card,
                          dtype=torch.int8)
        s = torch.rand(nb, generator=g, device=card) * 1e-5 + 1e-7
        args = (x, m, q, q.flip(0).contiguous(), vals * 0.05, idx, s, s * 2)
    else:
        v = (torch.rand(d, generator=g, device=card) * 1e-4).to(
            getattr(torch, dtype))
        args = (x, m, v, v * 2, vals * 0.05, idx)
    kw = dict(n_div=n, option=option, block=block, state_dtype=dtype, **HP)
    got = ops.fedams_ingest(*args, **kw)
    want = ref.fedams_ingest_ref(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same(a, b)
    vhat = got[5] if dtype == "int8" else got[3]   # int8: v-hat's scales
    assert bool(vhat.float().isnan().any()) == nan


@pytest.mark.parametrize("case", ref.INGEST_HARD_CASES, ids=lambda c: c[0])
def test_fedams_ingest_kernel_matches_twin_on_hard_cases(card, case):
    """Every case of ``ref.INGEST_HARD_CASES``, one launch a call, bitwise
    at each state dtype and both options."""
    name, d, block, n, k, kind = case
    for dtype in ("float32", "bfloat16", "int8"):
        args = ref.ingest_case(d, block, n, k, dtype, kind, device=card)
        if kind == "offset":
            assert args[0].data_ptr() % 16 == 4
        for option in (1, 2):
            kw = dict(n_div=n, option=option, block=block, state_dtype=dtype,
                      **HP)
            n0 = ops.launches["fedams_ingest"]
            got = ops.fedams_ingest(*args, **kw)
            assert ops.launches["fedams_ingest"] == n0 + 1
            want = ref.fedams_ingest_ref(*args, **kw)
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, want)):
                assert _same(a, b), f"{name}, {dtype}, option {option}: " \
                                    f"output {i}"
            if kind == "zero block" and dtype == "int8":   # scale 1e-30
                tiny = float(torch.tensor(1e-30))
                assert float(got[4][1]) == tiny
                assert option == 1 or float(got[5][1]) == tiny
            if kind == "nan":
                vhat = got[5] if dtype == "int8" else got[3]
                assert bool(vhat.float().isnan().any())


@pytest.mark.parametrize("option", [1, 2])
@pytest.mark.parametrize("n", [704266, 4096, 1])
def test_fedams_update_kernel_matches_twin(card, option, n):
    g = torch.Generator(device=card).manual_seed(n)
    ins = [torch.randn(n, generator=g, device=card),
           torch.randn(n, generator=g, device=card) * 1e-3,
           torch.rand(n, generator=g, device=card) * 1e-4,
           torch.rand(n, generator=g, device=card) * 2e-4,
           torch.randn(n, generator=g, device=card) * 1e-2]
    ins[4][::97] = float("nan")   # non-finite deltas, e.g. a diverged client
    got = ops.fedams_update(*ins, option=option, **HP)
    want = ref.fedams_update_ref(*ins, option=option, **HP)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same(a, b)
    assert got[3].isnan().sum() == len(range(0, n, 97))


def test_launch_counts_and_wrapper_checks(card):
    ops.reset_launches()
    x = torch.zeros(2, 256, device=card)
    err = torch.zeros(4, 256, device=card)
    ops.topk_ef_sparse(x, err, torch.tensor([0, 1], device=card), k=4,
                       block=128)
    assert ops.launches["topk_ef_sparse"] == 1
    with pytest.raises(TypeError, match="int64"):
        ops.topk_ef_sparse(x, err, torch.tensor([0, 1], device=card,
                                                dtype=torch.int32),
                           k=4, block=128)
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_ef_sparse(x.t().contiguous().t(), err,
                           torch.tensor([0, 1], device=card), k=4, block=128)
    for rows, match in (([0, 4], "in"), ([-1, 2], "in"), ([1, 1], "distinct")):
        with pytest.raises(ValueError, match=match):
            ops.topk_ef_sparse(x, err, torch.tensor(rows, device=card), k=4,
                               block=128)
    assert ops.launches["topk_ef_sparse"] == 1


@pytest.mark.parametrize("d,block,k,ties", [
    (704266, 2048, 32, False), (704266, 2048, 1, False),
    (5000, 2048, 32, True), (1000, 384, 6, False), (300, 128, 1, True),
    (704266, 2048, 1024, False), (5000, 2048, 2048, True)])
def test_topk_ef_kernel_matches_twin(card, d, block, k, ties):
    g = torch.Generator(device=card).manual_seed(d + k + 1)
    if ties:
        x = torch.randint(-2, 3, (3, d), generator=g, device=card).float()
        err = torch.zeros(7, d, device=card)
    else:
        x = torch.randn(3, d, generator=g, device=card)
        err = torch.randn(7, d, generator=g, device=card) * 0.3
    rows = torch.tensor([6, 0, 3], device=card)
    e_k, e_r = err.clone(), err.clone()
    hk = ops.topk_ef(x, e_k, rows, k=k, block=block)
    hr = ref.topk_ef(x, e_r, rows, k=k, block=block)
    torch.cuda.synchronize()
    assert torch.equal(hk, hr) and torch.equal(e_k, e_r)


@pytest.mark.parametrize("block,k", [
    (block, k) for block in (128, 384, 2048)
    for k in (1, 2, 31, 32, 33, 1024, block) if k <= block])
def test_topk_kernels_match_twins_on_hard_cases(card, block, k):
    """Both top-k kernels at d = 704,266 (a 1,802-value tail) on
    ``ref.topk_hard_cases``: magnitudes equal but for the last radix digit,
    all-equal magnitudes, more ties at the threshold than are kept, NaNs
    (fewer and more than k) beside ±inf, ±0.0 and denormals. The EF rows
    hold -0.0, which adds nothing."""
    x = ref.topk_hard_cases(3, 704266, seed=block + k).to(card)
    err = torch.full((7, 704266), -0.0, device=card)
    err[[1, 2, 4, 5]] = torch.randn(4, 704266, device=card)
    rows = torch.tensor([6, 0, 3], device=card)
    e_k, e_r = err.clone(), err.clone()
    got = [*ops.topk_ef_sparse(x, e_k, rows, k=k, block=block), e_k]
    want = [*ref.topk_ef_sparse(x, e_r, rows, k=k, block=block), e_r]
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))
    e_k, e_r = err.clone(), err.clone()
    hk = ops.topk_ef(x, e_k, rows, k=k, block=block)
    hr = ref.topk_ef(x, e_r, rows, k=k, block=block)
    torch.cuda.synchronize()
    assert _same(hk, hr) and _same(e_k, e_r)


@pytest.fixture
def nan_fill():
    """Deterministic mode: ``torch.empty`` fills new floats with NaN, so an
    output element the kernel leaves unwritten cannot match the twin."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _sign_inputs(card, c, d, seed):
    """(c, d) deltas and a (c + 2, d) EF buffer with its rows: client 0
    has zeros and -0.0 (x = -0.0 on err = -0.0 gives a total of -0.0), and
    client c - 1 of c >= 2 a NaN total."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(c, d, generator=g, device=card)
    x[0, ::5] = 0.0
    x[0, 1::5] = -0.0
    err = torch.randn(c + 2, d, generator=g, device=card) * 0.1
    rows = torch.randperm(c + 2, generator=g, device=card)[:c].contiguous()
    err[rows[0], ::7] = 0.0
    err[rows[0], 1::5] = -0.0
    if c >= 2:
        x[c - 1, d // 2] = float("nan")
    return x, err, rows


def _sign_check(x, e_k, e_r, rows, hk, hr):
    c, d = x.shape
    assert _same(hk, hr) and _same(e_k, e_r)
    if c >= 2:
        assert bool(hk[c - 1].isnan().all())
    assert not bool(hk[:max(c - 1, 1)].isnan().any())
    assert bool((hk[0, 1::5] > 0).all())          # sign(-0.0) = +1


@pytest.mark.parametrize("c,d", [
    (3, 704266), (3, 8192), (3, 2049), (3, 1), (3, 2048 * 8195 + 7),
    (1, 704266), (12, 704266), (3, 2047), (3, 2048)])
def test_sign_ef_kernel_matches_twin(card, nan_fill, c, d):
    """Bitwise, scale included (the kernel's trees are the twin's), with
    zeros, -0.0 and a client whose totals hold a NaN; one launch a call.
    At d = 2048·8195 + 7 a client has more partials than one tree takes
    (``ref.SIGN_CHUNK``), so its scale sums in chunks, and it, like 12
    clients of 704,266, has more blocks than the card holds on chip, so
    some are read again."""
    x, err, rows = _sign_inputs(card, c, d, seed=c * d)
    e_k, e_r = err.clone(), err.clone()
    ops.reset_launches()
    hk = ops.sign_ef(x, e_k, rows)
    assert ops.launches["sign_ef"] == 1
    hr = ref.sign_ef(x, e_r, rows)
    torch.cuda.synchronize()
    _sign_check(x, e_k, e_r, rows, hk, hr)


def test_sign_ef_rereads_past_the_cards_capacity(card, nan_fill):
    """More 2048-value blocks than the SMs' opt-in shared memory holds
    (one CTA an SM at most holds optin // 8 KiB blocks): the blocks past a
    CTA's share are summed, dropped and read again for the write."""
    props = torch.cuda.get_device_properties(card)
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    held = props.multi_processor_count * (optin // (ref.SIGN_BLOCK * 4))
    d = 704266
    nb = -(-d // ref.SIGN_BLOCK)
    c = held // nb + 2
    assert c * nb > held
    x, err, rows = _sign_inputs(card, c, d, seed=7)
    e_k, e_r = err.clone(), err.clone()
    hk = ops.sign_ef(x, e_k, rows)
    hr = ref.sign_ef(x, e_r, rows)
    torch.cuda.synchronize()
    _sign_check(x, e_k, e_r, rows, hk, hr)


def test_sign_ef_back_to_back_and_on_a_second_stream(card, nan_fill):
    """The per-client arrival counts start over on every call: three calls
    in a row on one stream with no sync between (each on the EF rows the
    last one wrote), then one on a second stream; each bitwise, one launch
    a call."""
    c, d = 10, 704266
    x, err, rows = _sign_inputs(card, c, d, seed=3)
    e_k, e_r = err.clone(), err.clone()
    ops.reset_launches()
    got = [ops.sign_ef(x * (i + 1), e_k, rows) for i in range(3)]
    e_mid = e_k.clone()
    want = [ref.sign_ef(x * (i + 1), e_r, rows) for i in range(3)]
    torch.cuda.synchronize()
    assert ops.launches["sign_ef"] == 3
    for hk, hr in zip(got, want):
        assert _same(hk, hr)
    assert _same(e_mid, e_r)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        hk = ops.sign_ef(x, e_k, rows)
    side.synchronize()
    hr = ref.sign_ef(x, e_r, rows)
    torch.cuda.synchronize()
    assert ops.launches["sign_ef"] == 4
    assert _same(hk, hr) and _same(e_k, e_r)
    assert bool(hk[c - 1].isnan().all()) and not hk[:c - 1].isnan().any()


@pytest.mark.parametrize("nbits", range(1, 33))
def test_pack_unpack_kernels_match_twins(card, nbits):
    count = 1000 + nbits
    g = torch.Generator(device=card).manual_seed(nbits)
    v = torch.randint(-2**31, 2**31 - 1, (count,), generator=g, device=card,
                      dtype=torch.int32)
    got = ops.pack_uint(v, nbits)
    want = ref.pack_uint(v, nbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    back = ops.unpack_uint(got, nbits, count)
    assert torch.equal(back, ref.unpack_uint(want, nbits, count))
    mask = (1 << nbits) - 1
    assert torch.equal(back.long() & mask, v.long() & mask)
    if nbits <= 8:
        b8 = ops.unpack_uint(got, nbits, count, torch.uint8)
        assert torch.equal(b8, ref.unpack_uint(want, nbits, count,
                                               torch.uint8))
        u8 = (v & mask).to(torch.uint8)
        assert torch.equal(ops.pack_uint(u8, nbits), want)


def test_new_kernels_count_launches_and_check_arguments(card):
    ops.reset_launches()
    x = torch.zeros(2, 256, device=card)
    err = torch.zeros(4, 256, device=card)
    rows = torch.tensor([0, 1], device=card)
    ops.topk_ef(x, err, rows, k=4, block=128)
    ops.sign_ef(x, err, rows)
    buf = ops.pack_uint(torch.ones(9, dtype=torch.uint8, device=card), 1)
    ops.unpack_uint(buf, 1, 9)
    ops.pack_uint(torch.ones(0, dtype=torch.uint8, device=card), 1)
    assert {n: ops.launches[n] for n in
            ("topk_ef", "sign_ef", "pack_uint", "unpack_uint")} == \
        {"topk_ef": 1, "sign_ef": 1, "pack_uint": 1, "unpack_uint": 1}
    with pytest.raises(ValueError, match="distinct"):
        ops.sign_ef(x, err, torch.tensor([1, 1], device=card))
    with pytest.raises(TypeError, match="uint8 or int32"):
        ops.pack_uint(torch.ones(9, dtype=torch.int64, device=card), 1)
    with pytest.raises(TypeError, match="cannot hold"):
        ops.unpack_uint(buf, 9, 9, torch.uint8)
    assert ops.launches["sign_ef"] == 1 and ops.launches["pack_uint"] == 1


def _rows_case(card, c, count, nbits, col, seed):
    """(c, count) int32 values and a (c, W) block of random bytes, W odd,
    so that with ``col`` the rows' streams start at many alignments mod
    16."""
    g = torch.Generator(device=card).manual_seed(seed)
    v = torch.randint(-2**31, 2**31 - 1, (c, count), generator=g,
                      device=card, dtype=torch.int32)
    nbytes = (count * nbits + 7) // 8
    width = col + nbytes + 5
    width += 1 - width % 2
    block = torch.randint(0, 256, (c, width), generator=g, device=card,
                          dtype=torch.uint8)
    return v, block


@pytest.mark.parametrize("c", [1, 3, 10])
@pytest.mark.parametrize("nbits", range(1, 33))
def test_pack_unpack_rows_kernels_match_twins(card, nan_fill, nbits, c):
    """Bitwise to the twins, whole blocks compared (bytes outside a row's
    stream must stay), at a ragged count and at a count of whole 16-byte
    rows (the 16-byte loads), at column offsets that with an odd row
    stride put the streams at every alignment mod 16; one launch a call
    whatever c is."""
    mask = (1 << nbits) - 1
    for count in (1000 + nbits, 1024):
        for col in (0, 3, 8, 13):
            v, block = _rows_case(card, c, count, nbits, col,
                                  seed=nbits * 97 + count + col)
            ops.reset_launches()
            got = ops.pack_uint_rows(v, nbits, block.clone(), col)
            back = ops.unpack_uint_rows(got, col, nbits, count)
            assert ops.launches["pack_uint"] == 1
            assert ops.launches["unpack_uint"] == 1
            want = ref.pack_uint_rows(v, nbits, block.clone(), col)
            back_r = ref.unpack_uint_rows(want, col, nbits, count)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert torch.equal(back, back_r)
            assert torch.equal(back.long() & mask, v.long() & mask)
            if nbits <= 8:
                u8 = (v & mask).to(torch.uint8)
                assert torch.equal(
                    ops.pack_uint_rows(u8, nbits, block.clone(), col), want)
                assert torch.equal(
                    ops.unpack_uint_rows(got, col, nbits, count,
                                         torch.uint8),
                    ref.unpack_uint_rows(want, col, nbits, count,
                                         torch.uint8))


def _special_totals(card, c, d, seed):
    """(c, d) fp32 totals, 60 % of them -0.0, +0.0, NaNs of several
    payloads, ±inf or denormals of both signs."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(c, d, generator=g, device=card)
    specials = torch.tensor(
        [0x80000000, 0x00000000, 0x7FC00000, 0xFFC00001, 0x7FFFFFFF,
         0x7F800000, 0xFF800000, 0x00000001, 0x807FFFFF, 0x80000001],
        dtype=torch.int64, device=card)
    specials = torch.where(specials >= 2**31, specials - 2**32,
                           specials).to(torch.int32)
    pick = torch.rand(c, d, generator=g, device=card) < 0.6
    which = torch.randint(0, specials.numel(), (c, d), generator=g,
                          device=card)
    bits = torch.where(pick, specials[which], x.view(torch.int32))
    return bits.view(torch.float32)


#: sign scales planted in the messages: NaNs, ±inf, ±0, a denormal, 0.2
SCALE_BITS = (0x7FC00000, 0xFFC00001 - 2**32, 0x7F800000, 0xFF800000 - 2**32,
              0, -2**31, 3, 0x3E4CCCCD)


@pytest.mark.parametrize("c,d,block", [
    (1, 704266, 0), (3, 1001, 0), (10, 704266, 0), (10, 8, 0),
    (3, 1001, 300), (10, 600, 300)])
def test_fused_sign_rows_kernels_match_twins(card, nan_fill, c, d, block):
    """The sign codec's fused forms, bitwise (NaN payloads included) to
    the twins: the ``>= 0`` predicate packed from fp32 totals with -0.0,
    NaNs, ±inf and denormals, into messages of 16 + 4·nsc + ceil(d/8)
    bytes (at d = 704,266 row r's stream starts at 6r + 4 mod 16); and the
    scaled unpack, each row's scale(s) read from the message, with NaN,
    ±inf, ±0 and denormal scales."""
    nsc = 1 if block == 0 else -(-d // block)
    col = 16 + 4 * nsc
    x = _special_totals(card, c, d, seed=c * d + block)
    width = col + (d + 7) // 8
    g = torch.Generator(device=card).manual_seed(d)
    msgs = torch.randint(0, 256, (c, width), generator=g, device=card,
                         dtype=torch.uint8)
    scales = torch.tensor(SCALE_BITS, dtype=torch.int32, device=card)
    pick = (torch.arange(c * nsc, device=card) % len(SCALE_BITS)).view(c, nsc)
    msgs[:, 16:col] = scales[pick].view(torch.uint8).view(c, 4 * nsc)
    ops.reset_launches()
    got = ops.pack_uint_rows(x, 1, msgs.clone(), col)
    hat = ops.unpack_uint_rows(got, col, 1, d, torch.float32, scale_col=16,
                               scale_block=block)
    assert ops.launches["pack_uint"] == 1 and ops.launches["unpack_uint"] == 1
    want = ref.pack_uint_rows(x, 1, msgs.clone(), col)
    hat_r = ref.unpack_uint_rows(want, col, 1, d, torch.float32,
                                 scale_col=16, scale_block=block)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(hat.view(torch.int32), hat_r.view(torch.int32))
    bits = ref.unpack_uint_rows(got, col, 1, d, torch.uint8)
    assert torch.equal(bits.bool(), x >= 0)      # -0.0 → 1, NaN → 0


def test_wire_codecs_rows_on_the_card_match_the_cpu(card):
    """``encode_rows`` / ``decode_rows`` of the sign and blocktopk codecs
    at the main path's shapes (10 clients × d = 704,266): the card's bytes
    and hats equal the CPU's (the twins) bit for bit."""
    from repro_torch.comm.wire import make_wire_codec
    g = torch.Generator(device=card).manual_seed(5)
    tot = torch.randn(10, 704266, generator=g, device=card) * 0.01
    for name in ("sign", "blocktopk"):
        codec = make_wire_codec(name, 1 / 64, 2048)
        bufs = codec.encode_rows(tot)
        hats = codec.decode_rows(bufs, tot.shape[1])
        bufs_c = codec.encode_rows(tot.cpu())
        torch.cuda.synchronize()
        assert torch.equal(bufs.cpu(), bufs_c)
        assert torch.equal(hats.cpu(), codec.decode_rows(bufs_c,
                                                         tot.shape[1]))


def test_rows_wrappers_check_arguments_on_the_card(card):
    ops.reset_launches()
    vals = torch.zeros(2, 9, device=card)
    out = torch.zeros(2, 30, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="nbits=1"):
        ops.pack_uint_rows(vals, 2, out, 20)
    with pytest.raises(ValueError, match="do not fit"):
        ops.pack_uint_rows(vals, 1, out, 29)
    with pytest.raises(ValueError, match="rows"):
        ops.pack_uint_rows(vals, 1, out[:1], 20)
    with pytest.raises(ValueError, match="scale_col"):
        ops.unpack_uint_rows(out, 20, 1, 9, torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.unpack_uint_rows(out, 20, 1, 9, torch.float32, scale_col=28)
    assert all(n == 0 for n in ops.launches.values())


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-32b",
                                  "hubert-xlarge"])
def test_model_on_the_card_matches_the_cpu(card, arch):
    """The zoo's smoke configs (fp32, TF32 off) on the card against the
    CPU, one init carried over: ``loss`` and every leaf of its gradient,
    and for the decoders ``prefill`` past the window (chunked, with a band)
    and 6 ``decode_step``s, within 1e-4 of the largest |value| (cuBLAS and
    the CPU's GEMMs sum in their own orders)."""
    import numpy as np
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.params import leaves_with_paths, tree_map
    from repro_torch.sharding.rules import ParallelContext
    ctx = ParallelContext()
    cfg = get_arch(arch).smoke
    model = Model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda t: t.to(card), cpu)
    r = np.random.default_rng(1)
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 40)).astype(
        np.int32))
    labels = torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 32)).astype(
        np.int32))
    if cfg.frontend is not None:
        batch = {"embeddings": torch.from_numpy(r.normal(
            size=(2, 32, cfg.d_model)).astype(np.float32)), "labels": labels}
    else:
        batch = {"tokens": toks[:, :32], "labels": labels}

    def close(a, b):
        a, b = a.detach().cpu().double(), b.detach().double()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())

    outs = {}
    for name, p in (("cpu", cpu), ("gpu", gpu)):
        dev = p["final_norm"].device
        p = tree_map(lambda t: t.clone().requires_grad_(True), p)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = model.loss(p, b, ctx, remat_policy="none", chunk=8)
        loss.backward()
        outs[name] = [loss] + [leaf.grad if leaf.grad is not None
                               else torch.zeros(()) for _, leaf in
                               leaves_with_paths(p)]
    for a, b in zip(outs["gpu"], outs["cpu"]):
        close(a, b)
    if cfg.is_encoder:
        return
    steps = {}
    with torch.no_grad():
        for name, p in (("cpu", cpu), ("gpu", gpu)):
            dev = p["final_norm"].device
            lg, c = model.prefill(p, toks[:, :32].to(dev), ctx, max_len=40,
                                  chunk=8)
            got = [lg]
            for i in range(32, 38):
                lg, c = model.decode_step(p, toks[:, i:i + 1].to(dev), c, i,
                                          ctx, max_len=40)
                got.append(lg)
            steps[name] = got
    for a, b in zip(steps["gpu"], steps["cpu"]):
        close(a, b)
