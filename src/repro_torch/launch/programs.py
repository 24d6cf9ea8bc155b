"""The step builders' and serving's jitted entry points as programs, with
the decode position on the device.

Counterpart of the reference's ``jax.jit`` of ``prefill`` and of the
decode step (``repro.launch.serve``: the prefill and ``dstep``, the decode
step with its greedy sample) and of the step builders' prefill and decode
(``repro.launch.steps``): each is one executable for every position, the
position a traced ``jnp.int32``. Here a :class:`Session` holds one
(model, weights, batch, prompt, ``max_len``, q-chunk, context) in two
programs over one carry (:class:`ServeCarry`: the caches, the next token,
the position as a 0-d int32 tensor and the running finiteness flag, all
static on the device):

  * the prefill program runs ``Model.prefill`` on its static prompt,
    writing the layers' caches straight into the carry
    (``Model.prefill(into=...)``), then the first token's
    ``greedy_sample``, the flag and the position;
  * the decode program runs ``Model.decode_step`` at the carry's
    position, writing the caches in place (``inplace=True``), then the
    sample (into the carry's token: the next step's input), the flag, and
    the position + 1.

On CUDA, where the bodies' collectives can be captured (NCCL or none:
``core.mesh.captures_rounds``), the first prefill runs each body once as a
dropped warm-up, then captures both into CUDA graphs that share one
memory pool (``torch.cuda.graph(..., pool=...)``: the largest temporaries,
a MoE layer's bf16 expert casts, are held once), and replays the prefill;
each decode call is one replay. Elsewhere (the CPU, gloo) the same bodies
run eagerly on the carry. The weights are read where they are (never
copied into a static input). A model configuration keeps one session at a
time (:class:`ServePrograms`, shared by every ``Model`` of that
configuration): a call at other weights' storage (each leaf's address,
shape, strides and dtype), shapes, context or settings that pick kernels
(deterministic algorithms, TF32) drops the session, its graphs, pool and
carry, and makes its own, so the programs hold one carry and one pool
whatever the shapes served; ``repro_torch.clear_caches()`` drops it too.
Inside ``repro_torch.disable_graphs()`` no program is made: the callers
run the eager twin (``Model.prefill``, ``Model.decode_step`` at an int).

The step builders' functions (:class:`PrefillStep`, :class:`DecodeStep`)
go through the session where it captures, and run the eager step
elsewhere (meta, the CPU, gloo), so the dry run and
``launch/op_analysis`` trace what the eager step runs. There the caches
are the session's carry, as a donated argument is: a prefill returns the
carry's caches, and a decode step handed them writes them in place and
returns them, with no copy; a decode step handed other caches of the same
shapes copies them into the carry once (the eager step's one copy), and
one handed caches that no session fits makes a session that adopts them.
Either way the caches a step returns are valid until the session's next
prefill or decode step. The reference's serving jit does not donate
(ROADMAP Queue 3).

The step builders' train step (:class:`TrainStep`) is the reference's
jitted ``fed_round``: the mesh's per-round program
(``core.mesh.build_fed_rounds_scan(...).round``), one captured round
replayed a call where the round's collectives can be captured, its staged
body run eagerly on the carry elsewhere (the CPU, gloo). It consumes the
state it is given and returns the program's carry, as ``launch/train.py``
does; the reference's step builder does not donate (ROADMAP Queue 3 item
40). On ``meta`` (the dry run, ``launch/op_analysis``) and inside
``repro_torch.disable_graphs()`` it runs the eager round, so the dry run
counts what the round runs.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch import graphs_enabled, register_programs
from repro_torch.core.mesh import build_fed_rounds_scan, captures_rounds
from repro_torch.models.model import greedy_sample
from repro_torch.models.params import tree_leaves


def _settings() -> tuple:
    """The settings that pick kernels: a program is kept per setting."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _storage(tree) -> tuple:
    """Where and how each tensor of ``tree`` is stored: a captured graph
    reads its weights at the addresses they had when it was captured."""
    return tuple((str(t.device), t.data_ptr(), tuple(t.shape), t.stride(),
                  t.dtype) for t in tree_leaves(tree))


def _shapes(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(tree))


class ServeCarry:
    """What a session's prefill writes and its decode reads and writes,
    static on the device: ``caches`` (written in place), ``token`` (B, 1)
    int32 (the next step's input), ``pos`` 0-d int32 (the next step's
    position) and ``finite`` (every logit so far finite)."""

    def __init__(self, caches, batch: int):
        dev = tree_leaves(caches)[0].device
        self.caches = caches
        self.token = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.finite = torch.ones((), dtype=torch.bool, device=dev)


class Session:
    """The prefill and the decode program of one model on one set of
    weights at one (batch, prompt, ``max_len``, q-chunk) under ``ctx``
    (``key``: what :class:`ServePrograms` keeps it by), over one
    :class:`ServeCarry` (``caches``: the carry's caches to adopt; None:
    zeros of ``Model.cache_defs``' shapes on this rank).
    ``captured``: whether the bodies run as CUDA graphs (in one pool, on a
    stream of the session's), else eagerly. ``captures``, and
    ``replays`` of each program (``"prefill"``, ``"decode"``);
    ``graphs`` the captured ones (``debug_dump`` reads their kernel
    nodes); ``logits`` each program's latest logits (on CUDA the graph's
    own tensor, which its next replay writes again)."""

    def __init__(self, model, ctx, device, *, key: tuple, batch: int,
                 prompt: int, max_len: int, chunk: int, caches=None):
        self.ctx, self.key = ctx, key
        self.prompt, self.max_len, self.chunk = prompt, max_len, chunk
        self.captured = captures_rounds(device, ctx)
        if caches is None:
            caches = model.init_cache(batch, max_len, device=device, ctx=ctx)
        self.carry = ServeCarry(caches, batch)
        self.tokens = torch.zeros((batch, prompt), dtype=torch.int32,
                                  device=device)
        self.pool = torch.cuda.graph_pool_handle() if self.captured else None
        self.stream = (torch.cuda.Stream(device) if self.captured else None)
        self.graphs, self.logits = {}, {}
        self.captures = 0
        self.replays = {"prefill": 0, "decode": 0}

    # -- the bodies ----------------------------------------------------------
    def _prefill(self, model, params):
        c = self.carry
        logits, _ = model.prefill(params, self.tokens, self.ctx,
                                  max_len=self.max_len, chunk=self.chunk,
                                  into=c.caches)
        c.finite.copy_(torch.isfinite(logits).all())
        c.token.copy_(greedy_sample(logits, self.ctx)[:, None])
        c.pos.fill_(self.prompt)
        return logits

    def _decode(self, model, params):
        c = self.carry
        logits, _ = model.decode_step(params, c.token, c.caches, c.pos,
                                      self.ctx, max_len=self.max_len,
                                      inplace=True)
        c.finite.logical_and_(torch.isfinite(logits).all())
        c.token.copy_(greedy_sample(logits, self.ctx)[:, None])
        c.pos.add_(1)
        return logits

    # -- running -------------------------------------------------------------
    def _capture(self, name: str, body, model, params) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # thread-local: another thread's CUDA calls (the NCCL watchdog's
        # event queries) do not void this capture
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            self.logits[name] = body(model, params)
        graph.instantiate()
        self.graphs[name] = graph
        self.captures += 1

    def _replay(self, name: str) -> None:
        self.graphs[name].replay()
        self.replays[name] += 1

    def prefill(self, model, params, tokens):
        """The prompt ``tokens`` (B, S) into the static prompt, then the
        prefill program: the carry holds the prompt's caches, the first
        token, the position S and the flag. Returns the last-position
        logits (B, V/tp). On CUDA the first call runs the bodies once each
        as a dropped warm-up (the prefill's replay rewrites all they
        wrote: every cache slot, the token, the position and the flag),
        hands the warm-up's blocks back to the card (a capture's pool
        cannot take them) and captures the prefill, then the decode step
        if the session has none yet, into the session's pool."""
        self.tokens.copy_(tokens)
        with torch.no_grad():
            if not self.captured:
                self.logits["prefill"] = self._prefill(model, params)
                self.replays["prefill"] += 1
                return self.logits["prefill"]
            here = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream):
                if "prefill" not in self.graphs:
                    decode = "decode" not in self.graphs
                    self._prefill(model, params)
                    if decode:
                        self._decode(model, params)
                    torch.cuda.empty_cache()
                    self._capture("prefill", self._prefill, model, params)
                    if decode:
                        self._capture("decode", self._decode, model, params)
            here.wait_stream(self.stream)
            self._replay("prefill")
        return self.logits["prefill"]

    def decode(self, model, params):
        """One decode step from the carry (its token and position), the
        caches written in place. Returns the logits (B, V/tp). On CUDA a
        replay; in a session whose decode is not captured yet (no prefill
        came first) the step runs eagerly on the carry, which is this
        call's result and the capture's warm-up, and is then captured for
        the calls after it (a capture runs nothing)."""
        with torch.no_grad():
            if not self.captured:
                self.logits["decode"] = self._decode(model, params)
                self.replays["decode"] += 1
                return self.logits["decode"]
            if "decode" not in self.graphs:
                here = torch.cuda.current_stream(self.stream.device)
                self.stream.wait_stream(here)
                with torch.cuda.stream(self.stream):
                    logits = self._decode(model, params)
                    torch.cuda.empty_cache()
                    self._capture("decode", self._decode, model, params)
                here.wait_stream(self.stream)
                return logits
            self._replay("decode")
        return self.logits["decode"]


class ServePrograms:
    """The serving programs of one model configuration: ``live``, its one
    session (None: none yet). A call at another key drops it, its graphs,
    pool and carry, before the new session is made;
    :meth:`clear_programs` drops it (``repro_torch.clear_caches``)."""

    def __init__(self):
        self.live = None
        register_programs(self)

    def clear_programs(self) -> None:
        self.live = None

    def session(self, model, params, ctx, *, batch: int, prompt: int,
                max_len: int, chunk: int, caches=None) -> Session:
        """The session for these weights, shapes, context and settings:
        the live one, or a new one in its place (``caches``: the new
        carry's, adopted)."""
        key = (_storage(params), batch, prompt, max_len, chunk, ctx,
               id(ctx.mesh), _settings())
        if self.live is None or self.live.key != key:
            captured = self.live is not None and self.live.captured
            self.live = None
            if captured:
                # the dropped session's pool and carry back to the card
                # before the new one allocates
                torch.cuda.empty_cache()
            self.live = Session(model, ctx, params["final_norm"].device,
                                key=key, batch=batch, prompt=prompt,
                                max_len=max_len, chunk=chunk, caches=caches)
        return self.live

    def decoder(self, model, params, ctx, caches, *, batch: int,
                max_len: int) -> Session:
        """A session to decode ``caches`` in: the live one where its
        weights, batch, ``max_len``, context and settings are these and its
        carry's caches have the shapes of ``caches`` (its prompt and
        q-chunk play no part in a decode step); else a new one that adopts
        ``caches`` as its carry."""
        sess = self.live
        if sess is not None:
            storage, b, _, ml, _, *rest = sess.key
            if ((storage, b, ml, *rest) == (_storage(params), batch, max_len,
                                             ctx, id(ctx.mesh), _settings())
                    and _shapes(sess.carry.caches) == _shapes(caches)):
                return sess
        return self.session(model, params, ctx, batch=batch, prompt=0,
                            max_len=max_len, chunk=0, caches=caches)


#: each model configuration's serving programs, for as long as a model
#: of it lives
_PROGRAMS = weakref.WeakValueDictionary()


def programs_of(model) -> ServePrograms:
    """The serving programs of ``model``'s configuration (its config and
    tp), kept with it: every ``Model`` of one configuration shares them,
    since a model holds no weights (the step builders' prefill and decode
    models, a caller's model and ``launch.serve.serve``'s)."""
    progs = model.__dict__.get("serve_programs")
    if progs is None:
        key = (model.cfg, model.tp)
        progs = _PROGRAMS.get(key)
        if progs is None:
            progs = _PROGRAMS[key] = ServePrograms()
        model.serve_programs = progs
    return progs


class PrefillStep:
    """``fn(params, tokens) -> (logits, caches)``: ``Model.prefill`` at
    ``max_len`` and ``chunk`` under ``ctx``, as the reference's jitted
    prefill. Where it captures (CUDA, NCCL or no process group) the
    session's prefill program: the logits are a copy, the caches the
    session's carry (the next decode step writes them in place, the next
    prefill of the session writes them again); elsewhere, and inside
    ``repro_torch.disable_graphs()``, the eager step."""

    def __init__(self, model, ctx, *, max_len: int, chunk: int):
        self.model, self.ctx = model, ctx
        self.max_len, self.chunk = max_len, chunk

    def eager(self, params, tokens):
        return self.model.prefill(params, tokens, self.ctx,
                                  max_len=self.max_len, chunk=self.chunk)

    def __call__(self, params, tokens):
        dev = tokens.device
        if not graphs_enabled() or not captures_rounds(dev, self.ctx):
            return self.eager(params, tokens)
        B, S = tokens.shape
        sess = programs_of(self.model).session(
            self.model, params, self.ctx, batch=B, prompt=S,
            max_len=self.max_len, chunk=self.chunk)
        logits = sess.prefill(self.model, params, tokens)
        return logits.clone(), sess.carry.caches


class DecodeStep:
    """``fn(params, token, caches, pos) -> (logits, caches)``:
    ``Model.decode_step`` at ``max_len`` under ``ctx``, as the reference's
    jitted decode step, ``pos`` an int or a 0-d int tensor. Where it
    captures (CUDA, NCCL or no process group) the session's decode
    program (:meth:`ServePrograms.decoder`): the caches are consumed, as a
    donated argument is; a session's carry is written in place, other
    caches are copied into the carry once and left as they were; the
    caches returned are the carry, the logits a copy. Elsewhere, and
    inside ``repro_torch.disable_graphs()``, the eager step (which leaves
    the caches given as they were)."""

    def __init__(self, model, ctx, *, max_len: int):
        self.model, self.ctx, self.max_len = model, ctx, max_len

    def eager(self, params, token, caches, pos):
        return self.model.decode_step(params, token, caches, pos, self.ctx,
                                      max_len=self.max_len)

    def __call__(self, params, token, caches, pos):
        dev = token.device
        if not graphs_enabled() or not captures_rounds(dev, self.ctx):
            return self.eager(params, token, caches, pos)
        sess = programs_of(self.model).decoder(
            self.model, params, self.ctx, caches, batch=token.shape[0],
            max_len=self.max_len)
        c = sess.carry
        for slot, given in zip(tree_leaves(c.caches), tree_leaves(caches)):
            if slot is not given:
                slot.copy_(given)
        c.token.copy_(token)
        if isinstance(pos, torch.Tensor):
            c.pos.copy_(pos)
        else:
            c.pos.fill_(pos)
        return sess.decode(self.model, params).clone(), c.caches


class TrainStep:
    """``fn(state, batch, seed) -> (state, metrics)``: this rank's mesh
    round ``eager`` (a ``core.mesh.MeshRound``) as the reference's jitted
    ``fed_round``, through ``rounds`` (its ``core.mesh.MeshRounds``, kept
    for the step's life: ``rounds.last`` and ``rounds.round_ms()`` report
    the latest call). On a real device each call is ``rounds.round``: on
    CUDA with NCCL or no process group one captured round replayed a call,
    on gloo and on the CPU the staged body run eagerly on the carry. The
    state given is consumed and the carry returned (ROADMAP Queue 3 item
    40); the metrics are 0-d tensors on the host. On ``meta`` and inside
    ``repro_torch.disable_graphs()`` (``rounds.round`` sees to that) the
    eager round runs on the caller's state and leaves it as it was.
    ``repro_torch.clear_caches()`` drops the program (``rounds`` is
    registered)."""

    def __init__(self, rnd):
        self.eager = rnd
        self.rounds = build_fed_rounds_scan(rnd)

    def __call__(self, state, batch, seed):
        if tree_leaves(state.params)[0].is_meta:
            return self.eager(state, batch, seed)
        return self.rounds.round(state, batch, seed)
