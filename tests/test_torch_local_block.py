"""FedSim's local phase: each block of clients trains as ONE
``torch.func.vmap`` program over the clients (``core.local.train_clients``),
the counterpart of the reference's ``jax.vmap`` over ``_local_train``.

On staged inputs (``test_torch_sim.py``'s numpy init, client ids drawn on
the JAX side, the same batches and step counts on both sides) the batched
block is held to the JAX vmapped ``_train_block`` for every local rule,
with and without heterogeneous step counts, and to its plain twin
``core.local.train_clients_loop`` (the clients one after another through
``torch.autograd``): bitwise on the MLP, within ``CONVMIXER_LOOP_ATOL`` on
the ConvMixer, where the grouped convolution vmap makes of the clients'
depthwise convolutions sums in another order. No operation of either loss
takes vmap's slow per-client fallback, a ``loss_fn`` torch.func cannot take
raises by name, and every path of the round (sync, ``client_chunk``,
faults, async) trains each block in one call."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core.sim import FedSim as JaxSim
from repro_torch.comm.faults import FaultConfig
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import sim as simmod
from repro_torch.core.local import autograd_grad_fn, train_clients_loop
from repro_torch.core.sim import FedSim
from repro_torch.models.model import Model
from repro_torch.sharding.rules import ParallelContext
from test_torch_sim import M, N, _cfg, _port_loss, _staged_rounds, staged_init

torch.set_num_threads(1)

#: the batched ConvMixer block against the loop, absolute (this CPU reads
#: 1.49e-8 for sgd and sgdm and 2.98e-8 for prox, against a largest |Δ| of
#: 0.052 to 0.076: a few ulps of the deltas)
CONVMIXER_LOOP_ATOL = 1e-7

#: the step counts handed to both packages when heterogeneity is on
STEPS = np.array([1, 2, 2, 1])


def _setup(model, **extra):
    defs, jloss, data = make_problem(model, M)
    kw = _cfg("b", **extra)
    js = JaxSim(jloss, JaxFedConfig(**kw))
    ts = FedSim(_port_loss(model), FedConfig(**kw), device="cpu")
    p0 = staged_init(defs)
    jstate = js.init(p0)
    tstate = ts.init(params_from_jax(jax.device_get(p0)))
    idx, b, key = _staged_rounds(data, 1)[0]
    return js, jstate, ts, tstate, b, key


@pytest.fixture
def fallback_warnings_are_errors():
    """vmap's warning for an operation without a batching rule (run once a
    client instead), raised as an error."""
    set_warn = torch._C._functorch._set_vmap_fallback_warning_enabled
    set_warn(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield
    finally:
        set_warn(False)


@pytest.mark.parametrize("hetero", [False, True], ids=["K", "K_i"])
@pytest.mark.parametrize("rule", ["sgd", "sgdm", "prox"])
@pytest.mark.parametrize("model", ["mlp", "convmixer"])
def test_batched_block_tracks_jax_and_its_loop_twin(
        model, rule, hetero, fallback_warnings_are_errors):
    """The batched block against the JAX vmapped ``_train_block`` (deltas
    within atol 1e-6 and rtol 1e-4, as test_round0_ef_rows_bitwise_given_
    the_same_deltas holds them; losses within 1e-5 relative), and against
    ``train_clients_loop`` on the autograd gradient: deltas and losses
    bitwise on the MLP; on the ConvMixer deltas within
    ``CONVMIXER_LOOP_ATOL`` and losses within 1e-6 relative. No vmap
    fallback warning."""
    js, jstate, ts, tstate, b, key = _setup(
        model, local_opt=rule, local_steps_min=1 if hetero else 0)
    k_blk = STEPS if hetero else None
    jdelta, jloss = js._train_block(
        js.unravel(jstate.x_client), jstate.x_client,
        jax.tree.map(jnp.asarray, b), key, 0.05,
        None if k_blk is None else jnp.asarray(k_blk))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    eta_l = torch.tensor(0.05)
    tk = None if k_blk is None else torch.from_numpy(k_blk)
    delta, loss = ts._train_block(tstate.x_client, tb, eta_l, tk)
    assert delta.shape == (N, tstate.x_client.numel()) and loss.shape == (N,)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta),
                               atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)

    ldelta, lloss = train_clients_loop(
        ts.rule, autograd_grad_fn(ts.loss_fn, ts.unravel), tstate.x_client,
        tb, eta_l, tk)
    if model == "mlp":
        assert torch.equal(delta, ldelta) and torch.equal(loss, lloss)
    else:
        assert (delta - ldelta).abs().max() <= CONVMIXER_LOOP_ATOL
        torch.testing.assert_close(loss, lloss, rtol=1e-6, atol=0)


class _NoSetupContext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        return 2 * g


class _NoVmapRule(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return 2 * x

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return 2 * g


_CAPTURED = torch.zeros(())

#: a loss torch.func cannot take, by the phrase FedSim's refusal names
REFUSED = {
    "item": (lambda loss: loss * float(loss.item() > 0),
             r"reads a tensor's value on the host"),
    "control-flow": (lambda loss: loss if loss > 0 else -loss,
                     r"control flow on a tensor's value"),
    "in-place": (lambda loss: loss + _CAPTURED.add_(loss),
                 r"writes in place into a tensor it did not make"),
    "function-without-setup-context": (_NoSetupContext.apply,
                                       r"autograd.Function .* no vmap rule"),
    "function-without-vmap-rule": (_NoVmapRule.apply,
                                   r"autograd.Function .* no vmap rule"),
}


@pytest.mark.parametrize("cause", list(REFUSED))
def test_a_loss_vmap_cannot_take_raises_by_name(cause):
    """A planted host read, Python branch, in-place write into a captured
    tensor, or autograd.Function torch.func cannot batch: FedSim's first
    round raises a RuntimeError naming the cause (and keeps torch.func's
    own message); it does not fall back to a loop over the clients."""
    wrap, phrase = REFUSED[cause]
    base = _port_loss("mlp")

    def loss_fn(p, b):
        loss, aux = base(p, b)
        return wrap(loss), aux

    _, _, ts, tstate, b, _ = _setup("mlp")
    ts.loss_fn = loss_fn
    with pytest.raises(RuntimeError, match=phrase) as err:
        ts.round(tstate, b, np.arange(N))
    assert "one torch.func.vmap program" in str(err.value)


def test_a_zoo_loss_with_remat_is_refused_by_name():
    """The zoo's remat (``models/stack.py::_remat``: ``torch.utils.
    checkpoint``'s saved tensor hooks, which torch.func.grad does not
    take) is refused by name; at ``remat_policy="none"`` the zoo loss
    trains through the batched block."""
    model = Model(get_arch("gemma2-2b").smoke)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    vocab = model.cfg.vocab_size
    gen = torch.Generator().manual_seed(1)
    batch = {key: torch.randint(0, vocab, (2, 1, 2, 8), generator=gen,
                                dtype=torch.int32)
             for key in ("tokens", "labels")}
    fed = FedConfig(num_clients=2, participating=2, local_steps=1,
                    compressor="blocktopk")
    for policy in ("full", "none"):
        sim = FedSim(lambda p, b, policy=policy: model.loss(
            p, b, ParallelContext(), remat_policy=policy), fed, device="cpu")
        state = sim.init(params)
        if policy == "full":
            with pytest.raises(RuntimeError, match="torch.utils.checkpoint"):
                sim.round(state, batch, np.arange(2))
        else:
            _, met = sim.round(state, batch, np.arange(2))
            assert np.isfinite(float(met["loss"]))


def test_the_fallback_warning_check_is_live(fallback_warnings_are_errors):
    """An operation without a batching rule (``renorm``) in the loss takes
    vmap's per-client fallback, whose warning the fixture raises: the
    check of the test above sees such an operation."""
    base = _port_loss("mlp")

    def loss_fn(p, b):
        loss, aux = base(p, b)
        return loss + p["w_out"].renorm(2, 0, 1.0).sum(), aux

    _, _, ts, tstate, b, _ = _setup("mlp")
    ts.loss_fn = loss_fn
    with pytest.raises(UserWarning, match="batching rule for aten::renorm"):
        ts.round(tstate, b, np.arange(N))


#: every path of FedSim's local phase, by its configuration: the block
#: sizes it trains a round
PATHS = {
    "sync": (dict(), [N]),
    "client_chunk": (dict(client_chunk=2), [2, 2]),
    "faults": (dict(fault=FaultConfig(crash_prob=0.3, seed=3),
                    track_gamma=False), [N]),
    "async": (dict(async_buffer=2, wire=True, track_gamma=False), [N]),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_trains_a_block_in_one_batched_call(path, monkeypatch):
    """Sync, ``client_chunk``, fault and async rounds each train a block
    of clients through one ``train_clients`` call (one vmap program), never
    client by client; on the MLP the staged rounds' losses equal a run
    whose local phase is the loop twin, to the bit."""
    extra, sizes = PATHS[path]
    defs, _, data = make_problem("mlp", M)
    staged = _staged_rounds(data, 2)
    ids = np.stack([s[0] for s in staged])
    batches = {k: np.stack([s[1][k] for s in staged]) for k in staged[0][1]}
    p0 = params_from_jax(jax.device_get(staged_init(defs)))
    fed = FedConfig(**_cfg("b", **extra))

    blocks = []
    batched = simmod.train_clients

    def counting(rule, grad_fn, flat0, b, eta_l, k_blk=None):
        blocks.append(next(iter(b.values())).shape[0])
        return batched(rule, grad_fn, flat0, b, eta_l, k_blk)

    monkeypatch.setattr(simmod, "train_clients", counting)
    sim = FedSim(_port_loss("mlp"), fed, device="cpu")
    _, mets = sim.run_rounds(sim.init(p0), batches, ids)
    assert blocks == sizes * 2

    twin = FedSim(_port_loss("mlp"), fed, device="cpu")
    twin._train_block = lambda flat0, b, eta_l, k_blk=None: \
        train_clients_loop(twin.rule,
                           autograd_grad_fn(twin.loss_fn, twin.unravel),
                           flat0, b, eta_l, k_blk)
    _, twin_mets = twin.run_rounds(twin.init(p0), batches, ids)
    assert [float(m["loss"]) for m in mets] == \
        [float(m["loss"]) for m in twin_mets]
