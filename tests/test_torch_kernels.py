"""The kernels' plain twins against the JAX package, bitwise: the Pallas
kernels run in interpret mode (as tests/test_kernels.py runs them) and the
``kernels/ref.py`` oracles as they are. Also the server optimizer and the
sparse aggregate the twins sit behind. The CUDA kernels themselves are held
to these twins on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import server_opt as jso
from repro.core import stages as jst
from repro.kernels import ref as jref
from repro.kernels.fedams_ingest import fedams_ingest as pallas_ingest
from repro.kernels.fedams_update import fedams_update as pallas_update
from repro.kernels.topk_ef import topk_ef_sparse as pallas_topk
from repro_torch.configs.base import FedConfig
from repro_torch.convert import server_state_from_jax, tensor_from_numpy
from repro_torch.core import server_opt as tso
from repro_torch.core import stages as tst
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

HP = dict(eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4)


def _np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _eq(jax_out, port_out, what=""):
    np.testing.assert_array_equal(_jnp(jax_out), _np(port_out), err_msg=what)


def _max_ulp(x0, a, b):
    """Largest |a - b| between two updated x vectors, in ulps of the step
    (``a - x0``) plus one ulp of the result: where ``x0 + step`` cancels
    near zero, an ulp of the result alone would blow up a one-ulp
    difference in the step."""
    x0 = np.asarray(x0, np.float64)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    step = np.abs(a.astype(np.float64) - x0).astype(np.float32)
    sp = np.spacing(step) + np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a.astype(np.float64) - b) / sp))


# -- topk_ef_sparse -----------------------------------------------------------


def _topk_inputs(seed, n, ties=False):
    r = np.random.default_rng(seed)
    if ties:
        x = (r.integers(-2, 3, size=n) * 0.5).astype(np.float32)
        return x, np.zeros(n, np.float32)
    return (r.normal(size=n).astype(np.float32),
            (r.normal(size=n) * 0.3).astype(np.float32))


@pytest.mark.parametrize("n,block,k,ties", [
    (4096, 2048, 32, False), (8192, 1024, 1, False), (1024, 128, 4, False),
    (4096, 2048, 32, True), (2048, 256, 1, True), (768, 384, 6, False),
    (4096, 2048, 1024, False), (1024, 256, 256, True)])
def test_topk_ef_sparse_twin_matches_pallas_bitwise(n, block, k, ties):
    x, e = _topk_inputs(n + k, n, ties)
    jv, ji, je = pallas_topk(jnp.asarray(x), jnp.asarray(e), k=k, block=block)
    err = torch.from_numpy(e)[None].clone()
    tv, ti = ops.topk_ef_sparse(torch.from_numpy(x)[None], err,
                                torch.tensor([0]), k=k, block=block)
    _eq(jv, tv[0], "vals")
    _eq(ji, ti[0], "idx")
    _eq(je, err[0], "new_err")


def test_topk_ef_sparse_twin_keeps_exactly_k_on_ties():
    """The exact-k contract (lowest indices first), unlike the threshold
    ``repro.kernels.ref.topk_ef_ref``."""
    x = torch.ones(1, 4096)
    err = torch.zeros(1, 4096)
    vals, idx = ref.topk_ef_sparse(x, err, torch.tensor([0]), k=7,
                                   block=2048)
    assert idx[0, 0].tolist() == list(range(7))
    assert idx[0, 1].tolist() == list(range(2048, 2055))
    assert int((err == 0).sum()) == 14
    hat, _ = jref.topk_ef_ref(jnp.ones(4096), jnp.zeros(4096), 7, 2048)
    assert int((np.asarray(hat) != 0).sum()) == 4096   # threshold keeps all


@pytest.mark.parametrize("rows,match", [([0, 4], r"\[0, 4\)"),
                                        ([-1, 2], r"\[0, 4\)"),
                                        ([1, 3, 1], "distinct")])
def test_topk_ef_sparse_rejects_bad_rows(rows, match):
    """The EF rows are updated in place: a row out of range or given twice
    raises before anything is written."""
    err = torch.zeros(4, 256)
    with pytest.raises(ValueError, match=match):
        ops.topk_ef_sparse(torch.ones(len(rows), 256), err,
                           torch.tensor(rows), k=4, block=128)
    assert not err.any()


@pytest.mark.parametrize("d,k", [(1000, 4), (300, 1), (2500, 8)])
def test_topk_ef_sparse_rows_match_compressor_select_on_ragged_d(d, k):
    """Several clients in one call, rows of a larger EF buffer, a ragged
    last block (padded positions compete as zeros): bitwise the JAX
    ``Compressor.select`` on ``delta + err`` and the EF rows the JAX sim
    stages leave behind."""
    from repro.core.compressors import block_layout, make_compressor
    block = block_layout(d, 256)[0]
    comp = make_compressor("blocktopk", k / block, 256)
    r = np.random.default_rng(d)
    errs = (r.normal(size=(6, d)) * 0.2).astype(np.float32)
    delta = r.normal(size=(3, d)).astype(np.float32)
    rows = np.array([4, 0, 2])
    je = jnp.asarray(errs).at[rows].add(jnp.asarray(delta))
    sel_vals, sidx, rx = jst.client_uplink_sparse(
        comp, None, d, jax.random.PRNGKey(0), je[rows], jnp.arange(3))
    je = jst.ef_update_sparse(je, jnp.asarray(rows), sidx, sel_vals, rx)
    te = torch.from_numpy(errs.copy())
    tv, ti = ops.topk_ef_sparse(torch.from_numpy(delta), te,
                                torch.from_numpy(rows), k=k, block=block)
    _eq(sel_vals, tv.reshape(3, -1), "vals")
    _eq(sidx, ti.reshape(3, -1), "idx")
    _eq(je, te, "EF buffer")


# -- fedams_update --------------------------------------------------------------


def _update_inputs(seed, n):
    r = np.random.default_rng(seed)
    return [np.asarray(np.abs(r.normal(size=n)) * 1e-3 if i in (2, 3)
                       else r.normal(size=n) * (0.1 if i == 4 else 1.0),
                       np.float32) for i in range(5)]


def _fma(beta: float, old, new_term):
    """``fma(beta, old, new_term)`` in fp32: one rounding of the exact
    value (fp64 holds a product of two fp32 exactly)."""
    return (np.float64(np.float32(beta)) * np.asarray(old, np.float64)
            + np.asarray(new_term, np.float64)).astype(np.float32)


@pytest.mark.parametrize("option", [1, 2])
@pytest.mark.parametrize("n", [4096, 5000])
def test_fedams_update_twin_vs_ref_and_pallas(option, n):
    """Bitwise against ``repro.kernels.ref.fedams_update_ref`` (separately
    rounded multiply-adds, as the CUDA kernel is built). The jitted Pallas
    program differs in one way only: XLA:CPU contracts ``b·old + (1-b)·new``
    into an FMA. Its m and v equal that FMA form bitwise, v̂ follows from v,
    and x stays within 4 ulp of the step."""
    arrs = _update_inputs(n + option, n)
    x, m, v, vh, d = arrs
    want = ref.fedams_update_ref(*map(torch.from_numpy, arrs),
                                 option=option, **HP)
    oracle = jref.fedams_update_ref(*map(jnp.asarray, arrs), option=option,
                                    **HP)
    for name, g, w in zip("x m v vhat".split(), oracle, want):
        _eq(g, w, f"vs repro.kernels.ref {name}")
    px, pm, pv, pvh = pallas_update(*map(jnp.asarray, arrs), option=option,
                                    **HP)
    m_fma = _fma(0.9, m, np.float32(1 - 0.9) * d)
    v_fma = _fma(0.99, v, np.float32(1 - 0.99) * (d * d))
    np.testing.assert_array_equal(np.asarray(pm), m_fma)
    np.testing.assert_array_equal(np.asarray(pv), v_fma)
    vh_fma = np.maximum(vh, v_fma)
    if option == 1:
        vh_fma = np.maximum(vh_fma, np.float32(1e-4))
    np.testing.assert_array_equal(np.asarray(pvh), vh_fma)
    assert _max_ulp(x, px, _np(want[0])) <= 4


# -- server_update ------------------------------------------------------------


@pytest.mark.parametrize("algo", ["fedams", "fedamsgrad", "fedcams",
                                  "fedadam", "fedyogi", "fedadagrad",
                                  "fedavg"])
@pytest.mark.parametrize("option", [1, 2])
def test_server_update_matches_jax(algo, option):
    """Three steps of the server optimizer on the flat vector: m/v/v̂
    bitwise, and x within 4 ulp (bitwise in practice: both sides round
    every op)."""
    kw = dict(algorithm=algo, option=option, eta=0.1, eps=1e-4)
    jfed, tfed = JaxFedConfig(**kw), FedConfig(**kw)
    r = np.random.default_rng(7)
    d = 3000
    x = r.normal(size=d).astype(np.float32)
    jstate = jso.init_server_state(jnp.asarray(x))
    tstate = tso.init_server_state(torch.from_numpy(x))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for step in range(3):
        delta = (r.normal(size=d) * 0.05).astype(np.float32)
        x0 = np.asarray(jx)
        jx, jstate = jso.server_update(jfed, jstate, jx, jnp.asarray(delta))
        tx, tstate = tso.server_update(tfed, tstate, tx,
                                       torch.from_numpy(delta))
        for name in ("m", "v", "vhat"):
            _eq(getattr(jstate, name), getattr(tstate, name),
                f"{algo} step {step} {name}")
        assert _max_ulp(x0, jx, _np(tx)) <= 4
    assert int(tstate.t) == int(jstate.t) == 3


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("option", [1, 2])
def test_server_update_quantized_state_matches_jax(dtype, option):
    kw = dict(algorithm="fedcams", option=option, eta=0.1, eps=1e-4,
              server_state_dtype=dtype)
    jfed, tfed = JaxFedConfig(**kw), FedConfig(**kw)
    r = np.random.default_rng(3)
    d, block = 1000, 256
    x = r.normal(size=d).astype(np.float32)
    jstate = jso.init_server_state(jnp.asarray(x), dtype, block)
    tstate = server_state_from_jax(jax.device_get(jstate))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for _ in range(3):
        delta = (r.normal(size=d) * 0.05).astype(np.float32)
        jx, jstate = jso.server_update(jfed, jstate, jx, jnp.asarray(delta))
        tx, tstate = tso.server_update(tfed, tstate, tx,
                                       torch.from_numpy(delta))
    _eq(jx, tx, "x")
    _eq(jstate.m, tstate.m, "m")
    for name in ("v", "vhat"):
        js, ts = getattr(jstate, name), getattr(tstate, name)
        if dtype == "int8":
            _eq(js.q, ts.q, name + ".q")
            _eq(js.scale, ts.scale, name + ".scale")
        else:
            _eq(js, ts, name)


def test_init_server_state_int8_layout():
    st = tso.init_server_state(torch.zeros(1000), "int8", 256)
    assert st.v.q.shape == (1024,) and st.v.q.dtype == torch.int8
    assert st.vhat.scale.shape == (4,)
    assert float(st.v.scale[0]) == np.float32(1e-30)


# -- fedams_ingest --------------------------------------------------------------


def _selections(seed, n, d, block, k):
    """Realistic (n, nb, k) selections: per-client blockwise top-k, so
    clients collide on some coordinates and the ragged tail can be
    picked."""
    r = np.random.default_rng(seed)
    tot = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    vals, idx = ref.topk_ef_sparse(tot, torch.zeros(n, d), torch.arange(n),
                                   k=k, block=block)
    return (vals * 0.05).numpy(), idx.numpy()


def _state(seed, dtype, N, nb):
    r = np.random.default_rng(seed)
    if dtype == "int8":
        q = r.integers(0, 128, size=N).astype(np.int8)
        qh = r.integers(0, 128, size=N).astype(np.int8)
        s = (r.random(nb) * 1e-5 + 1e-7).astype(np.float32)
        return q, qh, s, (s * 1.5).astype(np.float32)
    v = (r.random(N) * 1e-4).astype(np.float32)
    vh = (v + r.random(N) * 1e-4).astype(np.float32)
    if dtype == "bfloat16":
        v, vh = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (v, vh))
    return v, vh


@pytest.mark.parametrize("selections", ["topk", "collide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("option", [1, 2])
def test_fedams_ingest_twin_matches_ref_and_pallas_bitwise(dtype, option,
                                                          selections):
    """``collide``: every client picks the same k coordinates of each block,
    adding (1e8, 1, -1e8, 1) in turn (``ref.ingest_case``), so a sum in any
    order but client-major differs: this pins the twin's add order, which
    the CUDA kernel is held to bitwise on the card, to the JAX oracle's
    and the Pallas kernel's."""
    n, nb, block, k = 4, 3, 256, 8
    N = nb * block
    if selections == "collide":
        case = ref.ingest_case(N, block, n, k, "float32", "collide", seed=3)
        vals, idx = case[4].numpy(), case[5].numpy()
        assert (idx == idx[:1]).all()
    else:
        vals, idx = _selections(option, n, N, block, k)
    r = np.random.default_rng(5)
    x = r.normal(size=N).astype(np.float32)
    m = (r.normal(size=N) * 1e-3).astype(np.float32)
    st = _state(9, dtype, N, nb)
    kw = dict(n_div=n, option=option, block=block, state_dtype=dtype, **HP)
    jargs = [jnp.asarray(a) for a in (x, m, st[0], st[1], vals, idx)]
    jscales = [jnp.asarray(a) for a in st[2:]]
    want_ref = jref.fedams_ingest_ref(*jargs, *jscales, **kw)
    want_pallas = pallas_ingest(*jargs, *jscales, **kw)
    targs = [tensor_from_numpy(a) for a in (x, m, *st, vals, idx)]
    targs = targs[:4] + targs[-2:] + targs[4:-2]   # scales after vals/idx
    got = ops.fedams_ingest(*targs, **kw)
    assert len(got) == len(want_ref) == len(want_pallas)
    for i, (wr, g) in enumerate(zip(want_ref, got)):
        _eq(wr, g, f"output {i} vs fedams_ingest_ref")
    # the jitted Pallas program contracts the moment updates into FMAs (see
    # test_fedams_update_twin_vs_ref_and_pallas): one fp32 rounding apart on
    # m/v/v̂, which bf16 storage can round one bf16 ulp apart and int8
    # storage one quantization step apart
    names = ["x", "m", "v", "vhat", "v_scale", "vh_scale"]
    for name, wp, g in zip(names, want_pallas, got):
        wp = _jnp(wp).reshape(-1).astype(np.float64)
        g = _np(g).reshape(-1).astype(np.float64)
        scale = np.max(np.abs(g))
        if dtype == "int8" and name in ("v", "vhat"):
            assert np.max(np.abs(wp - g)) <= 1, name
        elif dtype == "bfloat16" and name in ("v", "vhat"):
            np.testing.assert_allclose(wp, g, rtol=2**-7, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(wp, g, rtol=4 * 2**-23,
                                       atol=4 * 2**-23 * scale, err_msg=name)


SMALL_HARD_CASES = [c for c in ref.INGEST_HARD_CASES if c[1] <= 20000]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", SMALL_HARD_CASES, ids=lambda c: c[0])
def test_fedams_ingest_twin_matches_jax_oracle_on_hard_cases(case, dtype):
    """The inputs the CUDA kernel is held to its twin on
    (``ref.INGEST_HARD_CASES``, at the sizes a CPU run takes): the twin
    equals ``repro.kernels.ref.fedams_ingest_ref`` bit for bit at both
    options. The JAX oracle runs over the padded (nb·block,) domain, so x,
    m and fp32/bf16 v, v̂ are zero-padded for it and its x, m, v, v̂ cut
    back to d."""
    name, d, block, n, k, kind = case
    args = ref.ingest_case(d, block, n, k, dtype, kind)
    nb = -(-d // block)
    pad = lambda a, w: np.pad(a, (0, nb * block - a.shape[0])) if w else a
    jargs = [jnp.asarray(pad(_np(t), i < 2 or dtype != "int8"))
             for i, t in enumerate(args[:4])]
    if dtype == "bfloat16":
        jargs[2:4] = [a.astype(jnp.bfloat16) for a in jargs[2:4]]
    jargs += [jnp.asarray(t.numpy()) for t in args[4:]]
    for option in (1, 2):
        kw = dict(n_div=n, option=option, block=block, state_dtype=dtype,
                  **HP)
        got = ops.fedams_ingest(*args, **kw)
        want = jref.fedams_ingest_ref(*jargs[:6], *jargs[6:], **kw)
        assert len(got) == len(want)
        for i, (w, g) in enumerate(zip(want, got)):
            w = _jnp(w)
            if i < 2 or dtype != "int8" and i < 4:
                w = w[:d]
            np.testing.assert_array_equal(w, _np(g), err_msg=f"output {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_server_ingest_matches_jax_on_ragged_d(dtype):
    """The FedSim entry point on a flat vector whose last block is ragged:
    the port ingests the (d,) vector directly (the kernel never pads it);
    the JAX side pads to nb·block and slices back. Bitwise against the
    eager JAX path (``impl="jnp"``, separately rounded like the port)."""
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4,
              server_state_dtype=dtype)
    d, block, n, k = 1000, 256, 3, 4
    nb = -(-d // block)
    r = np.random.default_rng(1)
    x = r.normal(size=d).astype(np.float32)
    jstate = jso.init_server_state(jnp.asarray(x), dtype, block)
    tstate = server_state_from_jax(jax.device_get(jstate))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for step in range(3):
        vals, idx = _selections(step, n, d, block, k)
        vals, idx = vals.reshape(n, -1), idx.reshape(n, -1)
        jx, jstate = jso.server_ingest(JaxFedConfig(**kw), jstate, jx,
                                       jnp.asarray(vals), jnp.asarray(idx),
                                       n, block=block, impl="jnp")
        tx, tstate = tso.server_ingest(FedConfig(**kw), tstate, tx,
                                       torch.from_numpy(vals),
                                       torch.from_numpy(idx), n, block=block,
                                       impl="kernel")
    _eq(jx, tx, "x")
    _eq(jstate.m, tstate.m, "m")
    for name in ("v", "vhat"):
        js, ts = getattr(jstate, name), getattr(tstate, name)
        if dtype == "int8":
            _eq(js.q, ts.q)
            _eq(js.scale, ts.scale)
        else:
            _eq(js, ts, name)
    assert tx.shape == (d,) and nb == 4


def test_server_aggregate_sparse_matches_jax_bitwise():
    d, n, block, k = 1000, 5, 256, 16
    vals, idx = _selections(11, n, d, block, k)
    vals, idx = vals.reshape(n, -1), idx.reshape(n, -1)
    want = jst.server_aggregate_sparse(jnp.asarray(vals), jnp.asarray(idx),
                                       d, n)
    got = tst.server_aggregate_sparse(torch.from_numpy(vals),
                                      torch.from_numpy(idx), d, n)
    _eq(want, got)


def test_fused_ingest_resolution():
    fed = lambda **kw: FedConfig(compressor="blocktopk", track_gamma=False,
                                 **kw)
    res = tst.resolve_fused_ingest
    assert res(fed(), eligible=True, have_kernel=True, compiled=True) \
        == "kernel"
    assert res(fed(), eligible=True, have_kernel=True, compiled=False) \
        == "jnp"
    assert res(fed(fused_ingest="kernel"), eligible=True, have_kernel=True,
               compiled=False) == "kernel"
    assert res(fed(), eligible=False, have_kernel=True, compiled=True) \
        == "off"
    with pytest.raises(ValueError, match="cannot fuse"):
        res(fed(fused_ingest="kernel"), eligible=False, have_kernel=True,
            compiled=True)
    assert res(dataclasses.replace(fed(), fused_ingest="off"),
               eligible=True, have_kernel=True, compiled=True) == "off"
