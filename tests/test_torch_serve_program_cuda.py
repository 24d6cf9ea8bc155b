"""Serving's programs on the card (``launch/programs.py``): the prefill and
the decode step each one CUDA graph per shape, captured into one shared
pool at the first prefill and replayed once a call, against their eager
twin under ``repro_torch.disable_graphs()``, to the bit under
deterministic algorithms; the step builders' prefill and decode chained
through the session's carry; one session a model configuration, so that
serving other shapes holds one pool and carry; and
``repro_torch.clear_caches()`` handing the programs' memory back to the
card. Marked ``cuda``: the ``card`` fixture skips without CUDA (decided
at run time). No jax here, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_serve_program_cuda.py
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch import clear_caches, disable_graphs
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch.programs import DecodeStep, PrefillStep, programs_of
from repro_torch.models.model import Model
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.sharding.rules import ParallelContext

pytestmark = pytest.mark.cuda

ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
         "recurrentgemma-2b", "xlstm-350m")
B, S, GEN = 2, 20, 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield torch.device("cuda")
    finally:
        torch.use_deterministic_algorithms(False)
        clear_caches()


@pytest.fixture
def captures(monkeypatch):
    """Counts the CUDA graph captures begun."""
    seen = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *args, **kw):
        seen.append(self)
        return begin(self, *args, **kw)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", counted)
    return seen


def _model(arch, dev):
    cfg = get_arch(arch).smoke
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dev)
    params["embed"]["table"].mul_(0.05)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return model, params, prompts


@pytest.mark.parametrize("arch", ARCHS)
def test_one_capture_a_program_and_the_eager_twin_to_the_bit(card, captures,
                                                             arch):
    """``generate`` through its session: two captures (the prefill and the
    decode step, one pool), one prefill replay and GEN - 1 decode replays;
    the tokens and the prefill's logits equal the eager twin's to the
    bit; a second call at the same shapes captures nothing more."""
    model, params, prompts = _model(arch, card)
    with disable_graphs():
        want = tserve.generate(model, params, prompts, GEN, log=None)
    assert not captures
    got = tserve.generate(model, params, prompts, GEN, log=None)
    sess = programs_of(model).live
    assert sess.captured and len(captures) == 2 and sess.captures == 2
    assert sess.replays == {"prefill": 1, "decode": GEN - 1}
    assert np.array_equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits0"], want["logits0"])
    assert got["finite"] and want["finite"]
    again = tserve.generate(model, params, prompts, GEN, log=None)
    assert len(captures) == 2 and programs_of(model).live is sess
    assert np.array_equal(again["tokens"], want["tokens"])


def test_the_step_builders_chain_through_the_carry(card, captures):
    """The step builders' prefill and decode (``PrefillStep``,
    ``DecodeStep``, on two models of one configuration, as
    ``launch/steps.py`` builds them) on the card: the prefill captures the
    prefill and the decode step (two captures for nine calls) and returns
    the session's carry; eight decode steps on it write it in place and
    return it, with no copy; the logits and caches equal the eager steps'
    at the same int positions, to the bit. Caches of the same shapes from
    elsewhere are copied into the carry and left as they were, with no
    capture; caches that no session fits (another ``max_len``) make a
    session that adopts them: its first step runs eagerly, then one
    capture, every step the eager one's to the bit."""
    model, params, prompts = _model("gemma2-2b", card)
    ctx = ParallelContext()
    prefill = PrefillStep(model, ctx, max_len=S + GEN, chunk=2048)
    step = DecodeStep(Model(model.cfg), ctx, max_len=S + GEN)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, size=(B, 8)).astype(np.int32)).to(card)
    prompt = torch.from_numpy(prompts).to(card)
    with torch.no_grad():
        lg0, carry = prefill(params, prompt)
        want_l0, want_c = prefill.eager(params, prompt)
        theirs = tree_map(torch.clone, want_c)
        got_l, want_l = [], []
        for i in range(8):
            pos = torch.tensor(S + i, dtype=torch.int32, device=card)
            lg, out = step(params, toks[:, i:i + 1], carry, pos)
            assert out is carry
            got_l.append(lg)
            lg_e, want_c = step.eager(params, toks[:, i:i + 1], want_c,
                                      S + i)
            want_l.append(lg_e)
    sess = programs_of(model).live
    assert len(captures) == 2 and sess.captures == 2
    assert sess.replays == {"prefill": 1, "decode": 8}
    assert torch.equal(lg0, want_l0)
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    for (_, a), (_, b) in zip(leaves_with_paths(carry),
                              leaves_with_paths(want_c)):
        assert torch.equal(a, b)

    kept = [t.clone() for _, t in leaves_with_paths(theirs)]
    with torch.no_grad():
        lg, out = step(params, toks[:, :1], theirs, S)
    assert out is carry and len(captures) == 2
    assert programs_of(model).live is sess and torch.equal(lg, want_l[0])
    assert all(torch.equal(a, t) for a, (_, t) in
               zip(kept, leaves_with_paths(theirs)))

    longer = DecodeStep(model, ctx, max_len=S + GEN + 4)
    with torch.no_grad():
        _, mine = model.prefill(params, prompt, ctx, max_len=S + GEN + 4)
        want_c = tree_map(torch.clone, mine)
        for i in range(3):
            lg, out = longer(params, toks[:, i:i + 1], mine, S + i)
            assert out is mine
            lg_e, want_c = longer.eager(params, toks[:, i:i + 1], want_c,
                                        S + i)
            assert torch.equal(lg, lg_e)
    new = programs_of(model).live
    assert new is not sess and new.carry.caches is mine
    assert len(captures) == 3 and new.replays == {"prefill": 0, "decode": 2}
    for (_, a), (_, b) in zip(leaves_with_paths(mine),
                              leaves_with_paths(want_c)):
        assert torch.equal(a, b)


def _reserved() -> int:
    """The card's reserved bytes once the allocator's free blocks (and
    cuBLAS's per-stream workspaces, which the allocator holds) are
    handed back."""
    torch.cuda.synchronize()
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def test_clear_caches_gives_the_programs_memory_back(card):
    """Serving three shapes leaves the last one's session, its graphs'
    pool and carry: the card's reserved bytes rise; after
    ``clear_caches()`` and ``torch.cuda.empty_cache()`` they are back at
    their level before the programs."""
    model, params, prompts = _model("qwen2-moe-a2.7b", card)
    with disable_graphs():
        tserve.generate(model, params, prompts, 4, log=None)
    before = _reserved()
    outs = [tserve.generate(model, params, prompts[:b, :s], 6, log=None)
            for b, s in ((2, 20), (1, 20), (2, 12))]
    assert programs_of(model).live.key[1:3] == (2, 12)
    del outs
    held = _reserved()
    assert held > before
    clear_caches()
    assert programs_of(model).live is None
    assert _reserved() == before, (before, held)


def test_other_shapes_take_the_sessions_place(card):
    """Two shapes served in turn, four times, with no ``clear_caches()``:
    each call drops the other shape's session (its graphs, pool and
    carry) before it captures its own, so the card's reserved bytes after
    the second round are no more than after the first, and the peak
    reserved of a round no more than the first round's."""
    model, params, prompts = _model("qwen2-moe-a2.7b", card)
    shapes = ((2, 20), (1, 16))
    rounds = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        for b, s in shapes:
            tserve.generate(model, params, prompts[:b, :s], 6, log=None)
        rounds.append((_reserved(), torch.cuda.max_memory_reserved()))
    assert programs_of(model).live.key[1:3] == shapes[-1]
    assert rounds[1][0] <= rounds[0][0] and rounds[1][1] <= rounds[0][1], \
        rounds
