"""The two-way (server→client) compressed downlink against the JAX
package: ``server_downlink`` on the same totals, in memory and over the
wire, and FedSim with ``two_way=True`` on staged ids, batches and init.

The sign compressor's scale is a sum whose order is not specified (the
port sums by ``sign_ef``'s halving trees, JAX by ``jnp.mean``): on totals
whose every partial sum is exact (multiples of 2^-12, d a power of two, so
the mean's division is exact too) the stage is held bitwise; on random
totals the scale is held within ``SIGN_ULP`` ulp, the signs equal, as
tests/test_torch_dense_uplink.py holds the uplink's. Two-way top-k
diverges after ~40 rounds in the reference itself, so its trajectory is
held over a few rounds only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.comm.wire import make_wire_codec as jax_codec
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core.compressors import make_compressor as jax_comp
from repro.core.sim import FedSim as JaxSim
from repro.core.stages import server_downlink as jax_downlink
from repro_torch.comm.wire import make_wire_codec
from repro_torch.configs.base import FedConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.compressors import make_compressor
from repro_torch.core.sim import FedSim
from repro_torch.core.stages import server_downlink
from repro_torch.kernels import ref
from test_torch_dense_uplink import SIGN_ULP, _ulps
from test_torch_sim import (EXACT_KEYS, LOSS_RTOL, M, N, _port_loss,
                            _staged_rounds, staged_init)

torch.set_num_threads(1)

D = 1024
RATIO, BLOCK = 1 / 32, 384    # blocks of 384: the last one padded


def _state(seed, dyadic):
    r = np.random.default_rng(seed)
    if dyadic:
        draw = lambda: (r.integers(-1000, 1001, size=D) * 2.0 ** -12
                        ).astype(np.float32)
    else:
        draw = lambda: (r.standard_normal(D) * 0.1).astype(np.float32)
    new, x, err = draw(), draw(), draw()
    if dyadic:
        new[::9] = x[::9] - err[::9]    # exact zeros of the total
    return new, x, err


def _both(name, wire, new, x, err):
    fed = dict(two_way=True, compressor=name, compress_ratio=RATIO,
               wire_block=BLOCK)
    comp = make_compressor(name, RATIO, BLOCK)
    codec = make_wire_codec(name, RATIO, BLOCK) if wire else None
    jc = jax_comp(name, RATIO, BLOCK)
    jcod = jax_codec(name, RATIO, BLOCK) if wire else None
    t = [torch.from_numpy(a) for a in (new, x, err)]
    got = server_downlink(FedConfig(**fed), comp, codec, *t)
    want = jax_downlink(JaxFedConfig(**fed), jc, jcod, D,
                        jax.random.PRNGKey(0), *map(jnp.asarray,
                                                    (new, x, err)))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("wire", [False, True], ids=["memory", "wire"])
@pytest.mark.parametrize("name", ["sign", "blocktopk"])
def test_downlink_matches_jax_bitwise(name, wire):
    """The new client model and the new server error, bit for bit, on the
    same totals (dyadic for sign, see the module docstring)."""
    new, x, err = _state(0, dyadic=name == "sign")
    got, want = _both(name, wire, new, x, err)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    assert not np.array_equal(got[0], new)          # the downlink is lossy


@pytest.mark.parametrize("wire", [False, True], ids=["memory", "wire"])
def test_sign_downlink_on_random_totals(wire):
    """Random totals: the port's downlink is ``x + hat`` and ``tot − hat``
    for ``hat = scale·sign(tot)`` with the port's tree-summed scale, bit for
    bit, and that scale is within ``SIGN_ULP`` ulp of the JAX mean."""
    new, x, err = _state(1, dyadic=False)
    got, _ = _both("sign", wire, new, x, err)
    tot = (new - x) + err
    scale = ref.sign_scale(torch.from_numpy(tot)[None]).numpy()[0]
    hat = np.where(tot >= 0, scale, -scale).astype(np.float32)
    np.testing.assert_array_equal(got[0], x + hat)
    np.testing.assert_array_equal(got[1], tot - hat)
    assert _ulps(scale, np.asarray(jnp.mean(jnp.abs(tot)))) <= SIGN_ULP


def test_downlink_is_a_passthrough_without_two_way():
    new, x, err = (torch.from_numpy(a) for a in _state(2, dyadic=False))
    got = server_downlink(FedConfig(), make_compressor("sign"), None, new,
                          x, err)
    assert got[0] is new and got[1] is err


@pytest.mark.parametrize("name,rounds", [
    ("sign", 10), ("sign-wire", 10), ("blocktopk", 4),
    ("blocktopk-wire", 4)])
def test_two_way_fedsim_tracks_jax_fedsim(name, rounds):
    """FedSim with ``two_way=True``: per-round loss within ``LOSS_RTOL`` of
    the JAX FedSim's, ``bits`` and the wire counters equal (the downlink
    bills the compressed message), and the clients' model x_client apart
    from the server's x."""
    comp, _, wire = name.partition("-")
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=2, num_clients=M, participating=N,
              compressor=comp, two_way=True, wire=bool(wire))
    defs, jloss, data = make_problem("mlp", M)
    p0 = staged_init(defs)
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss("mlp"), FedConfig(**kw), device="cpu")
    jst, tst = js.init(p0), ts.init(params_from_jax(jax.device_get(p0)))
    for idx, b, key in _staged_rounds(data, rounds):
        jst, jm = js.round(jst, jax.tree.map(jnp.asarray, b),
                           jnp.asarray(idx), key)
        tst, tm = ts.round(tst, b, idx)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        for k in EXACT_KEYS:
            if k in jm:
                assert tm[k] == jm[k], k
    if wire:
        assert tm["wire_down_bytes"] == N * ts.codec.nbytes(ts._d)
    assert not torch.equal(tst.x_client, tst.params)
    np.testing.assert_allclose(tst.x_client.numpy(),
                               np.asarray(jst.x_client), atol=1e-4)
    np.testing.assert_allclose(tst.server_error.numpy(),
                               np.asarray(jst.server_error), atol=1e-4)
