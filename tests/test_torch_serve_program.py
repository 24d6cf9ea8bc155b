"""Serving's prefill and decode as programs (``launch/programs.py``), on the
CPU at smoke size, where the programs' bodies run eagerly on their carry:
the caches written in place, the next token and the position kept on the
device.

* Each decode body (and each prefill body) runs under
  ``tests/host_reads.py``'s ``NoHostReads`` at a 0-d tensor position, on
  the smoke configs of gemma2-2b (decoding past its window of 16: the
  rings wrap), qwen2-moe-a2.7b (the MoE FFN), deepseek-v3-671b (MLA's
  latent cache), recurrentgemma-2b (RG-LRU state and a local-attention
  ring) and xlstm-350m (mLSTM + sLSTM state): a body that passes has no
  host sync to break a capture on the card.
* ``launch.serve.generate`` through the programs equals its eager twin
  under ``repro_torch.disable_graphs()`` to the bit: the tokens and the
  prefill's logits, on the five configs.
* Twenty decode positions build one decode program: one session, its
  decode run twenty times. A model configuration keeps one session:
  another shape takes the live one's place, every ``Model`` of the
  configuration shares it, and a decode step finds it for caches of its
  shapes (``ServePrograms.decoder``).
* The program's decode at the carry's tensor positions matches the
  reference's jitted decode (``jax.jit`` of ``decode_step`` at
  ``jnp.int32`` positions, as ``repro.launch.serve`` jits it) from params
  staged with numpy, the same tokens fed at every step, within
  ``tests/test_torch_serve.py``'s tolerance: 1e-5 of the largest |logit|.
* ``Model.decode_step`` at an int and at a 0-d tensor position, in place
  or not, gives the same logits and caches to the bit.
* The sequence-sharded cache write (``attention._write_slot``) writes one
  slot a rank: the token where the rank's block holds it, every other
  slot of every rank bitwise as it was.
* The step builders' ``fn`` on the CPU is the eager step.
"""
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from host_reads import NoHostReads
from repro.models.model import Model as JaxModel
from repro.sharding.rules import ParallelContext as JaxCtx
from repro_torch import disable_graphs
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch.programs import DecodeStep, PrefillStep, programs_of
from repro_torch.models import attention as attn
from repro_torch.models.model import Model
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.sharding.rules import ParallelContext
from test_torch_serve import CASES, close
from test_torch_sim import staged_init

torch.set_num_threads(1)

CTX = ParallelContext()
ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
         "recurrentgemma-2b", "xlstm-350m")
#: a prompt past gemma2-2b's and recurrentgemma's smoke windows (16), and
#: decode steps that carry the rings further round
B, S, GEN = 2, 20, 12


def _models(arch, seed: int = 0):
    """(JAX model, port model, JAX params, port params): the params staged
    with numpy from ``seed`` (the same bits in every process), the
    embedding table scaled by 0.05 so that the layers, not the table, pick
    the tokens (``tests/test_torch_serve.py``'s CLI checks do the same)."""
    jc, tc = CASES[arch]
    jm, tm = JaxModel(jc), Model(tc)
    jp = staged_init(jm.defs(), seed)
    jp["embed"]["table"] = jp["embed"]["table"] * np.float32(0.05)
    return jm, tm, jp, model_params_from_jax(jax.device_get(jp), "cpu")


def _prompts(cfg, seed: int = 5, length: int = S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, length)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_bodies_read_no_host_value(arch):
    """The prefill body and every decode body of a session, at the
    carry's 0-d position, under ``NoHostReads``."""
    _, tm, _, tp = _models(arch)
    sess = programs_of(tm).session(tm, tp, CTX, batch=B, prompt=S,
                                   max_len=S + GEN, chunk=2048)
    sess.tokens.copy_(torch.from_numpy(_prompts(tm.cfg)))
    with torch.no_grad(), NoHostReads():
        sess._prefill(tm, tp)
        for _ in range(GEN - 1):
            assert sess.carry.pos.dim() == 0
            sess._decode(tm, tp)
    assert int(sess.carry.pos) == S + GEN - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_is_its_eager_twin_to_the_bit(arch):
    """``generate`` through its session against ``generate`` under
    ``disable_graphs()`` (``Model.prefill`` and ``Model.decode_step`` at
    int positions, op by op): the tokens, the prefill's logits and the
    finiteness flag equal; the twin builds no program."""
    _, tm, _, tp = _models(arch)
    prompts = _prompts(tm.cfg)
    with disable_graphs():
        want = tserve.generate(tm, tp, prompts, GEN, log=None)
    assert programs_of(tm).live is None
    got = tserve.generate(tm, tp, prompts, GEN, log=None)
    assert np.array_equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits0"], want["logits0"])
    assert got["finite"] == want["finite"] is True
    assert len({tuple(r) for r in got["tokens"].T}) > 1
    assert programs_of(tm).live.replays == {"prefill": 1, "decode": GEN - 1}


def test_twenty_positions_build_one_decode_program():
    """Twenty decode steps (positions 20 … 39) through one session: one
    prefill and one decode program, the decode run twenty times; a second
    call at the same shapes reuses them; another batch takes the
    session's place, and the first batch again is a new session with the
    same tokens."""
    _, tm, _, tp = _models("gemma2-2b")
    prompts = _prompts(tm.cfg)
    first = tserve.generate(tm, tp, prompts, 21, log=None)
    sess = programs_of(tm).live
    assert sess.replays == {"prefill": 1, "decode": 20}
    assert int(sess.carry.pos) == S + 20
    again = tserve.generate(tm, tp, prompts, 21, log=None)
    assert programs_of(tm).live is sess
    assert np.array_equal(again["tokens"], first["tokens"])
    assert sess.replays == {"prefill": 2, "decode": 40}
    tserve.generate(tm, tp, prompts[:1], 21, log=None)
    other = programs_of(tm).live
    assert other is not sess and other.key[1:3] == (1, S)
    third = tserve.generate(tm, tp, prompts, 21, log=None)
    assert programs_of(tm).live not in (sess, other)
    assert np.array_equal(third["tokens"], first["tokens"])


def test_a_model_configuration_keeps_one_session():
    """Every ``Model`` of one configuration shares its serving programs
    (a model holds no weights); another configuration has its own; the
    programs go with the configuration's last model."""
    _, tm, _, tp = _models("gemma2-2b")
    again = Model(tm.cfg)
    assert programs_of(again) is programs_of(tm)
    assert programs_of(Model(tm.cfg, tp=2)) is not programs_of(tm)
    tserve.generate(again, tp, _prompts(tm.cfg), 4, log=None)
    sess = programs_of(tm).live
    assert sess is not None and sess.replays == {"prefill": 1, "decode": 3}
    tserve.generate(tm, tp, _prompts(tm.cfg)[:1], 4, log=None)
    assert programs_of(again).live is not sess
    _, qm, _, qp = _models("qwen2-moe-a2.7b")
    tserve.generate(qm, qp, _prompts(qm.cfg), 4, log=None)
    assert programs_of(qm).live.key[1] == B
    assert programs_of(tm).live.key[1] == 1
    ref = weakref.ref(programs_of(tm))
    del tm, again, sess
    gc.collect()
    assert ref() is None


def test_a_decode_step_finds_the_session_of_its_caches():
    """``ServePrograms.decoder``: the live session where its weights,
    batch, ``max_len`` and context are the step's and its carry has the
    caches' shapes, whatever its prompt; else a new session that adopts
    the caches given as its carry."""
    _, tm, _, tp = _models("gemma2-2b")
    progs = programs_of(tm)
    sess = progs.session(tm, tp, CTX, batch=B, prompt=S, max_len=S + GEN,
                         chunk=2048)
    caches = tm.init_cache(B, S + GEN, device="cpu", ctx=CTX)
    assert progs.decoder(tm, tp, CTX, sess.carry.caches, batch=B,
                         max_len=S + GEN) is sess
    assert progs.decoder(tm, tp, CTX, caches, batch=B,
                         max_len=S + GEN) is sess
    longer = tm.init_cache(B, S + GEN + 1, device="cpu", ctx=CTX)
    new = progs.decoder(tm, tp, CTX, longer, batch=B, max_len=S + GEN + 1)
    assert new is not sess and progs.live is new
    assert new.carry.caches is longer and new.key[2] == 0
    other = tree_map(torch.clone, tp)
    assert progs.decoder(tm, other, CTX, longer, batch=B,
                         max_len=S + GEN + 1) is not new


@pytest.mark.parametrize("arch", ARCHS)
def test_the_decode_program_tracks_the_jitted_reference(arch):
    """The session's prefill, then GEN - 1 decode programs at the carry's
    tensor positions, each fed the same token as the reference's jitted
    decode at ``jnp.int32`` positions (``jax.jit`` as
    ``repro/launch/serve.py`` jits ``dstep``): logits within 1e-5 of the
    largest |logit| at every step (fp32; the two sides sum in their own
    orders: ``tests/test_torch_serve.py``), and every cache leaf within
    1e-5 of its largest |value| at the end."""
    jm, tm, jp, tp = _models(arch, seed=3)
    toks = _prompts(tm.cfg, seed=8, length=S + GEN)
    max_len = S + GEN
    jctx = JaxCtx()
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, jctx, max_len=max_len))(
        jp, jnp.asarray(toks[:, :S]))
    jstep = jax.jit(lambda p, tk, c, pos: jm.decode_step(
        p, tk, c, pos, jctx, max_len=max_len))
    sess = programs_of(tm).session(tm, tp, CTX, batch=B, prompt=S,
                                   max_len=max_len, chunk=2048)
    tl = sess.prefill(tm, tp, torch.from_numpy(toks[:, :S]))
    close(tl, jl, 1e-5, f"{arch} prefill")
    for i in range(GEN - 1):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jstep(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        sess.carry.token.copy_(torch.from_numpy(tok))
        assert int(sess.carry.pos) == S + i
        tl = sess.decode(tm, tp)
        close(tl, jl, 1e-5, f"{arch} decode step {i}")
    jd = dict(leaves_with_paths(jax.device_get(jc)))
    for path, leaf in leaves_with_paths(sess.carry.caches):
        close(leaf, jd[path], 1e-5, f"{arch} cache {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_a_tensor_position_is_an_int_position_to_the_bit(arch):
    """``decode_step`` at ``S`` and at ``torch.tensor(S, int32)``, out of
    place and in place (on a copy): the same logits and caches, bit for
    bit; out of place leaves the caches given as they were."""
    _, tm, _, tp = _models(arch)
    toks = torch.from_numpy(_prompts(tm.cfg, length=S + 1))
    with torch.no_grad():
        _, caches = tm.prefill(tp, toks[:, :S], CTX, max_len=S + GEN)
        before = [t.clone() for _, t in leaves_with_paths(caches)]
        want, new = tm.decode_step(tp, toks[:, S:], caches, S, CTX,
                                   max_len=S + GEN)
        pos = torch.tensor(S, dtype=torch.int32)
        got, new_t = tm.decode_step(tp, toks[:, S:], caches, pos, CTX,
                                    max_len=S + GEN)
        assert all(torch.equal(a, t) for a, (_, t) in
                   zip(before, leaves_with_paths(caches)))
        mine = tree_map(torch.clone, caches)
        got_i, new_i = tm.decode_step(tp, toks[:, S:], mine, pos, CTX,
                                      max_len=S + GEN, inplace=True)
    assert new_i is mine
    for lg in (got, got_i):
        assert torch.equal(lg, want)
    for tree in (new_t, new_i):
        for (pa, a), (pb, b) in zip(leaves_with_paths(new),
                                    leaves_with_paths(tree)):
            assert pa == pb and torch.equal(a, b), pa


def _seq_ctx(rank: int):
    """The two calls ``_write_slot`` makes of a sequence-sharded context."""
    return types.SimpleNamespace(seq_axis="data", seq_index=lambda: rank)


@pytest.mark.parametrize("inplace", (False, True))
@pytest.mark.parametrize("gslot", (0, 5, 7, 8, 13, 15))
def test_the_seq_sharded_write_touches_one_slot(gslot, inplace):
    """A 16-slot cache over two ranks of 8: each rank writes its one
    clamped local slot (``where(hit, new, old)``); the new token lands on
    the rank whose block holds ``gslot``, and every other slot of every
    rank, the other rank's clamped slot included, is bitwise as it was.
    The slot ids are the block's global ones."""
    gen = torch.Generator().manual_seed(gslot)
    blocks = [attn.KVCache(torch.randn(2, 8, 3, 4, generator=gen),
                           torch.randn(2, 8, 3, 4, generator=gen))
              for _ in range(2)]
    new = (torch.randn(2, 1, 3, 4, generator=gen),
           torch.randn(2, 1, 3, 4, generator=gen))
    pos = torch.tensor(gslot, dtype=torch.int32)
    for rank, cache in enumerate(blocks):
        before = [t.clone() for t in cache]
        with NoHostReads():
            out, ids = attn._write_slot(cache, new, pos, 16, _seq_ctx(rank),
                                        attn.KVCache, inplace)
        assert torch.equal(ids, rank * 8 + torch.arange(8))
        assert all((o is c) == inplace for o, c in zip(out, cache))
        if not inplace:
            assert all(torch.equal(c, b) for c, b in zip(cache, before))
        for o, b, x in zip(out, before, new):
            want = b.clone()
            if rank * 8 <= gslot < rank * 8 + 8:
                want[:, gslot - rank * 8] = x[:, 0]
            assert torch.equal(o, want), (rank, gslot)


def test_the_step_builders_run_the_eager_step_off_the_card():
    """On the CPU (and on meta, gloo) the bundles' ``fn`` is the eager
    step: the caches given are left as they were, and no session is
    made."""
    _, tm, _, tp = _models("gemma2-2b")
    toks = torch.from_numpy(_prompts(tm.cfg, length=S + 1))
    prefill = PrefillStep(tm, CTX, max_len=S + GEN, chunk=2048)
    decode = DecodeStep(tm, CTX, max_len=S + GEN)
    with torch.no_grad():
        lg, caches = prefill(tp, toks[:, :S])
        want_lg, want_c = tm.prefill(tp, toks[:, :S], CTX, max_len=S + GEN)
        assert torch.equal(lg, want_lg)
        before = [t.clone() for _, t in leaves_with_paths(caches)]
        got, new = decode(tp, toks[:, S:], caches, S)
        want, _ = tm.decode_step(tp, toks[:, S:], caches, S, CTX,
                                 max_len=S + GEN)
    assert torch.equal(got, want) and new is not caches
    assert all(torch.equal(a, t) for a, (_, t) in
               zip(before, leaves_with_paths(caches)))
    assert programs_of(tm).live is None
