"""The paper-faithful simulation backend: ``FedSim``.

Counterpart of ``repro.core.sim.FedSim``. It runs the paper's Algorithms 1
and 2 on one device: m clients with an (m, d) error-feedback buffer that
stays resident on the device, n sampled clients per round training K local
steps each, the select-once sparse uplink, and the FedAMS server step.

One round (``_round_impl``):

* each sampled client runs K local steps from the model it sees
  (``core.local``) and yields its delta;
* the uplink, sparse or dense:

  - sparse (the top-k family, by default): ``stages.client_uplink_sparse``
    adds the deltas to the clients' EF rows, selects ``(vals, idx)`` once
    per client and leaves the residual in the rows — for blocktopk through
    the ``topk_ef_sparse`` kernel;
  - dense (``sparse_uplink=False``, or sign/int8/identity):
    ``stages.client_uplink`` compresses ``delta + e`` per client and keeps
    ``tot − hat`` in the rows — in memory through the ``sign_ef`` /
    ``topk_ef`` kernels for sign and blocktopk, or, in wire mode, through
    the codec's ``encode_rows``→``decode_rows`` over all n clients at once
    (one ``pack_uint`` and one ``unpack_uint`` launch, whatever
    ``wire_pack_impl`` says); the server averages the hats;

* the server either ingests the selections in one fused pass
  (``fused_ingest`` resolves to ``"kernel"``/``"jnp"``: the
  ``fedams_ingest`` kernel or its plain twin) or takes the two-pass
  ``server_update`` on the mean (the ``fedams_update`` kernel for the
  FedAMS family).

With ``fed.wire=True`` every delta is serialized to packed bytes
(``comm.wire``), timed through a simulated network (``comm.transport``,
host-side numpy keyed by (seed, round, client)) and decoded; the round's
metrics then carry the measured ``wire_*`` bytes, ``round_time_s`` and
``sim_time_s`` (``comm.metrics.CommLog``) next to the analytic ``bits``.
With ``fed.two_way`` the server's update goes down compressed too, with
its own EF (``stages.server_downlink``; in wire mode through the codec).

With ``fed.fault`` (or a bare ``fed.deadline_s``) a round runs
:meth:`FedSim._fault_round`: a host-side ``comm.faults.FaultInjector``
plans crashes, deadline cuts and payload corruption before the round, the
server validates every payload before ingest and aggregates the survivors
only, and the metrics gain ``survivors``, ``rejected``, ``crashed`` and
``deadline_cut``.

Scale-out: ``fed.ef_store`` keeps the (m, d) EF rows host-side in a
``checkpoint.store.EFStore`` and the device holds the cohort's (n, d)
block (gathered before the round, scattered back after it, the next
round's rows prefetched meanwhile); ``fed.client_chunk`` trains and uplinks
the cohort in chunks of that many clients (one ``topk_ef_sparse`` launch a
chunk on the sparse path), summing into a running aggregate; and
``fed.agg_groups`` aggregates in two tiers (a dense partial per group,
then their sum), billing the g partials as tier-2 wire bytes.

One program per shape, as the reference jits its rounds: every round
runs as one program (:class:`_Program`, one per shape and setting, kept
with the FedSim), on CUDA one CUDA graph captured at its first call after
one dropped warm-up run and replayed once a call, on the CPU the same body
run eagerly. :meth:`FedSim.round` stages its round on the host — the ids
(checked there), the network timing and fault plan, the step counts and
randk's positions drawn from its generator, η_l, the batches — loads them
into its program, whose carry adopts the state's EF buffer (updated in
place) and holds copies of the rest, and runs it once; the new state and
the metrics come back as tensors of their own. :meth:`FedSim.run_rounds`
(the reference's ``lax.scan`` over rounds) stages all R rounds first, and
its program's body (:meth:`FedSim._rounds_body`, the round's own) runs
round after round on a copy of the state, reading its round's inputs at a
round counter on the device: R replays, no host work between them and one
host read of the stacked metrics. Every kernel of the round runs inside
the graph as itself; the launch counters count what the wrappers launched
(the warm-up run's), and the capture's launches are kept with the
program. The host counters (``bits``, the wire bytes and times, the fault
verdicts) are booked after, as in the reference, through one helper for
both drivers. A round takes η_l as a 0-d tensor and masks heterogeneous
steps on the device (``core.local``), so the drivers compute one thing, to
the bit. Inside :func:`repro_torch.disable_graphs` a round runs eagerly on
the caller's state (:meth:`FedSim._eager_round`), and :meth:`FedSim.run_rounds`
R such rounds on a copy of it, as ``jax.disable_jit()`` runs the
reference's; no program is built there. :meth:`FedSim.clear_programs`
(``repro_torch.clear_caches``) drops the programs kept.

With ``fed.async_buffer`` the rounds are event-driven
(``comm.async_engine.AsyncRoundEngine``): :meth:`FedSim.run_rounds`
dispatches the staged cohorts and flushes every B deliveries, each step
one program (:meth:`FedSim._dispatch` adopts the EF buffer,
:meth:`FedSim._flush` carries the server state); :meth:`FedSim.round`
refuses. With ``fed.ef_store`` :meth:`FedSim.run_rounds` is a loop of
:meth:`FedSim.round` (the cohort's rows move host↔device each round, into
and out of the round program's (n, d) block), as in the reference.

randk draws its positions every round (``compressors.randk_positions``,
from the round's generator): the n clients' sets, γ's and the two-way
downlink's.

Differences from the JAX class: the state holds the FLAT (d,) model
(``FedSim.unravel`` gives the dict of views in JAX shapes); a round updates
the input state's EF buffer in place, as the JAX round donates it, so keep
only the returned state (``run_rounds`` works on its own copy and leaves
the input state as it was); randk takes drawn positions where the JAX
compressor takes a PRNG key.

Local training is the reference's: each block of clients (the cohort, a
``client_chunk`` chunk or an async cohort) trains as one
``torch.func.vmap`` program over the clients (``core.local.train_clients``,
the gradient by ``torch.func.grad_and_value``), on every path and inside
``run_rounds``' graph; a ``loss_fn`` that torch.func cannot take raises at
the first round, naming the cause. ``core.local.train_clients_loop`` is its
plain twin, one client after another, which FedSim never calls.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import graphs_enabled, register_programs, resolve_device
from repro_torch.checkpoint.store import EFStore
from repro_torch.comm.async_engine import AsyncRoundEngine
from repro_torch.comm.faults import (FaultConfig, FaultInjector, FaultPlan,
                                     corrupt_dense, corrupt_selection,
                                     plan_to_device, stack_plans,
                                     validate_dense, validate_selection)
from repro_torch.comm.metrics import CommLog
from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
from repro_torch.comm.wire import make_dense32_codec, make_wire_codec
from repro_torch.configs.base import FedConfig
from repro_torch.core.compressors import (Compressor, block_layout,
                                          make_compressor, randk_positions)
from repro_torch.core.local import (func_grad_fn, hetero_step_counts,
                                    local_lr, make_local_update,
                                    train_clients)
from repro_torch.core.server_opt import (FUSED_INGEST_GROUPS_DETAIL,
                                         init_server_state, server_ingest,
                                         server_update)
from repro_torch.core.stages import (client_uplink, client_uplink_sparse,
                                     gamma_diagnostic, resolve_fused_ingest,
                                     scatter_add_clients,
                                     server_aggregate_sparse,
                                     server_aggregate_sparse_grouped,
                                     server_aggregate_sparse_masked,
                                     server_aggregate_sparse_weighted,
                                     server_downlink, stage)
from repro_torch.kernels import ops, ref
from repro_torch.models.params import ravel

#: runs of a round's body on a side stream before its capture, so that what
#: initializes lazily (the cuBLAS/cuDNN handles and workspaces, the
#: autograd engine's device thread, the kernels' first-use attributes, the
#: codecs' cached headers) does so outside the capture
WARMUP_ROUNDS = 1

#: what torch.func refuses in a loss_fn: the phrases of its messages, and
#: the cause FedSim names
_VMAP_CAUSES = (
    ((".item() on a Tensor",),
     "it reads a tensor's value on the host (.item(), or Python control "
     "flow on a tensor's value)"),
    (("mutate a captured Tensor",),
     "it writes in place into a tensor it did not make"),
    (("autograd.Function", "does not have vmap support"),
     "an autograd.Function in it has no vmap rule"),
    (("saved tensor hooks",),
     "it recomputes activations through torch.utils.checkpoint (saved "
     "tensor hooks; a zoo loss's remat_policy other than 'none')"),
)


def _vmap_refusal(err: RuntimeError) -> Optional[str]:
    """The named cause of a ``torch.func`` refusal, or None when ``err``
    is not one."""
    msg = str(err)
    for phrases, cause in _VMAP_CAUSES:
        if any(phrase in msg for phrase in phrases):
            return cause
    if any(word in msg for word in ("vmap", "functorch", "torch.func")):
        return "torch.func refused an operation of it"
    return None


class SimState(NamedTuple):
    params: torch.Tensor        # (d,) flat model (ravel_pytree order)
    opt: object                 # ServerState over the flat vector
    errors: torch.Tensor        # (m, d) per-client EF errors — or, with
    # fed.ef_store, the (n, d) cohort rows of the last round (the full store
    # lives host-side)
    server_error: torch.Tensor  # (d,) server-side EF error (two-way mode)
    x_client: torch.Tensor      # (d,) model as clients see it
    bits: int                   # cumulative one-way communicated bits
    round: int


class _Staged(NamedTuple):
    """R rounds' inputs on the device, each leading with R: what
    :meth:`FedSim._rounds_body` reads at its round counter."""
    batches: dict                   # name → (R, n, K, ...)
    idx: torch.Tensor               # (R, n) int64 client ids
    eta_l: torch.Tensor             # (R,) fp32
    k_all: Optional[torch.Tensor]   # (R, n) int64 step counts, or None
    draws: Optional[torch.Tensor]   # (R, n + 2, k) int64 randk positions
    fplan: Optional[FaultPlan]      # (R, n) device plan, or None


def _host_ids(client_idx) -> np.ndarray:
    """Client ids (a host array or a tensor) as a host int64 array."""
    if isinstance(client_idx, torch.Tensor):
        client_idx = client_idx.cpu().numpy()
    return np.array(client_idx, dtype=np.int64)


def _core(state: SimState):
    """The device part of a state: params, opt, errors, server_error,
    x_client."""
    return tuple(state[:5])


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _shapes(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _tensors(tree))


class _Program:
    """One function of one FedSim as one program, the port's counterpart
    of a jitted function: its carry (the state it updates: copies of the
    caller's tensors, or, at the positions ``adopt`` names, the caller's
    own tensors, updated in place), its static inputs, a round counter on
    the device and the (keys, ``rounds``) metric slots. ``body`` names the
    function, a method of the FedSim that :meth:`run` is given, called as
    ``sim.<body>(prog)``: it reads the inputs (at the counter) and the
    carry, writes the carry and the slots, and returns its outputs (or
    None). An adopted slot stays the first caller's tensor: a later
    caller's tensor there is lent in for the run (:meth:`load`), with no
    new program.
    On CUDA the body is captured once into a CUDA graph, after
    :data:`WARMUP_ROUNDS` runs on its own stream whose writes to the carry
    are undone; each later run replays it. Without a card the body runs
    eagerly on the same buffers. ``counts``: the kernel launches the
    capture recorded into the graph
    (:func:`repro_torch.kernels.ops.captured_launches`), which each replay
    runs again; ``replays``: the replays so far.
    :data:`repro_torch.kernels.ops.launches` counts only the launches a
    wrapper made (the warm-up's)."""

    def __init__(self, body: str, carry, inputs, keys, rounds: int, device,
                 adopt=()):
        self.body = body
        self.keys = keys
        self.device = device
        own = lambda tree: pytree.tree_map(
            lambda x: x.to(device, copy=True)
            if isinstance(x, torch.Tensor) else x, tree)
        self.carry = tuple(t if i in adopt else own(t)
                           for i, t in enumerate(carry))
        self.adopt = tuple(adopt)
        # the adopted positions' tensors of the latest caller, and the
        # slots lent to it
        self.given = {i: carry[i] for i in self.adopt}
        self.lent = []
        # the inputs' own slots: a caller's tensor may share its memory
        # with the caller's arrays (a CPU tensor from numpy)
        self.inputs = own(inputs)
        self.ctr = torch.zeros(1, dtype=torch.int64, device=device)
        self.out = torch.zeros((len(keys), rounds), dtype=torch.float32,
                               device=device)
        self.graph = self.counts = self.outputs = None
        self.replays = 0
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def load(self, carry, inputs):
        """The state into the carry and the inputs into the static inputs
        (a tensor that is its slot already is not copied), the counter to
        0. An adopted slot given another tensor (another chain's EF
        buffer, a restored state's) lends it in: the slot's own contents
        are kept aside, and :meth:`run` copies the slot back into the
        tensor and the kept contents into the slot, so the slot's owner
        sees its buffer as it left it (one clone and three copies a call,
        against a new capture)."""
        self.given = {i: carry[i] for i in self.adopt}
        self.lent = [(self.carry[i], carry[i], self.carry[i].clone())
                     for i in self.adopt if carry[i] is not self.carry[i]]
        for dst, src in zip(_tensors((self.carry, self.inputs)),
                            _tensors((carry, inputs))):
            if dst is not src:
                dst.copy_(src)
        self.ctr.zero_()

    def write(self, core, met):
        """A round's new state into the carry (a part the round left as it
        was, or updated in place, is its slot already), its metrics into
        column ``ctr``; the counter + 1."""
        for dst, src in zip(_tensors(self.carry), _tensors(core)):
            if src is not dst:
                dst.copy_(src)
        for j, key in enumerate(self.keys):
            self.out[j].index_copy_(0, self.ctr,
                                    met[key].reshape(1).to(self.out.dtype))
        self.ctr.add_(1)

    def run(self, sim: "FedSim", times: int = 1):
        """``sim``'s body ``times`` times from the loaded state: on CUDA as
        replays of its graph (captured at the first run), else eagerly.
        Returns the last run's outputs (on CUDA the graph's own tensors,
        which the next replay writes again)."""
        body = getattr(sim, self.body)
        if self.stream is None:
            for _ in range(times):
                self.outputs = body(self)
        else:
            here = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream):
                if self.graph is None:
                    self._capture(body)
                for _ in range(times):
                    self.graph.replay()
                self.replays += times
            here.wait_stream(self.stream)
        for slot, theirs, kept in self.lent:
            theirs.copy_(slot)
            slot.copy_(kept)
        self.lent = []
        return self.outputs

    def _capture(self, body):
        """The warm-up runs (their writes to the carry undone: the carry
        and the counter are put back as they were loaded), then the
        capture; a capture that fails raises."""
        saved = [t.clone() for t in _tensors(self.carry)]
        for _ in range(WARMUP_ROUNDS):
            body(self)
        for dst, src in zip(_tensors(self.carry), saved):
            dst.copy_(src)
        del saved
        self.ctr.zero_()
        # the warm-up's freed blocks back to the card: the capture's pool
        # is its own and cannot reuse them
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with ops.captured_launches() as counts:
            with torch.cuda.graph(graph, stream=self.stream):
                self.outputs = body(self)
        graph.instantiate()
        self.graph, self.counts = graph, counts

    def result(self):
        """The carry after the run: at an adopted position the caller's
        tensor, every other part as tensors of its own."""
        return tuple(
            self.given[i] if i in self.adopt else pytree.tree_map(
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x, t)
            for i, t in enumerate(self.carry))


class FedSim:
    """Federated simulation over ``loss_fn(params_dict, batch) -> (loss,
    aux)``, where ``params_dict`` holds tensors in the JAX shapes.

    ``device``: where the state and the round run; ``None`` means CUDA and
    raises without a card (pass ``device="cpu"`` to run on the CPU).
    ``network``: the wire mode's ``comm.transport.SimulatedNetwork``
    (default: ``NetworkConfig()`` over ``fed.num_clients``)."""

    def __init__(self, loss_fn: Callable, fed: FedConfig,
                 compressor: Optional[Compressor] = None,
                 network: Optional[SimulatedNetwork] = None, *, device=None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.fed = fed
        self.rule = make_local_update(fed)
        if compressor is None and fed.algorithm == "fedcams":
            compressor = make_compressor(fed.compressor, fed.compress_ratio,
                                         fed.wire_block)
        self.comp = compressor if fed.algorithm == "fedcams" else None
        self.sparse = (self.comp is not None
                       and self.comp.select is not None
                       if fed.sparse_uplink is None
                       else bool(fed.sparse_uplink))
        if self.sparse and (self.comp is None or self.comp.select is None):
            raise ValueError(
                "sparse_uplink=True needs a compressor with a .select "
                "(topk/blocktopk family); this one has none")
        n_round = fed.participating or fed.num_clients
        if fed.client_chunk and 0 < fed.client_chunk < n_round \
                and n_round % fed.client_chunk:
            raise ValueError(
                f"client_chunk={fed.client_chunk} must divide the "
                f"per-round client count n={n_round} — a silent fallback "
                f"to the full (n, d) vmap would defeat the memory bound")
        if fed.agg_groups > 1:
            # groups merge compacted selections: the dense paths can't
            if not self.sparse:
                raise ValueError(
                    "FedConfig.agg_groups > 1 needs the select-once sparse "
                    "(vals, idx) uplink — this config resolved the dense "
                    "reference path (no compacted selection to group-merge)")
            if fed.client_chunk and 0 < fed.client_chunk < n_round \
                    and fed.client_chunk != n_round // fed.agg_groups:
                raise ValueError(
                    f"client_chunk={fed.client_chunk} and agg_groups="
                    f"{fed.agg_groups} both set: the chunk must equal the "
                    f"group size n//g={n_round // fed.agg_groups} so each "
                    f"scan step is exactly one group's tier-1 merge")
        chunked = bool(fed.client_chunk) and 0 < fed.client_chunk < n_round
        # a bare fed.deadline_s means "deadline cutoff, no injected faults"
        fcfg = fed.fault
        if fed.deadline_s > 0:
            fcfg = (FaultConfig(deadline_s=fed.deadline_s) if fcfg is None
                    else dataclasses.replace(fcfg, deadline_s=fed.deadline_s))
        self.faults = (FaultInjector(fcfg, fed.num_clients)
                       if fcfg is not None else None)
        eligible = (self.sparse and self.comp.name.startswith("blocktopk")
                    and not fed.track_gamma and not chunked
                    and fed.agg_groups <= 1 and self.faults is None)
        self._fused = resolve_fused_ingest(
            fed, eligible=eligible, have_kernel=True,
            compiled=self.device.type == "cuda",
            detail="FedSim fuses only the unchunked sparse blocktopk "
                   "uplink with track_gamma=False (the γ diagnostic and "
                   "the client_chunk scan both consume a dense aggregate) "
                   "and no fault injection (the masked survivor aggregate "
                   "needs the unfused scatter path)"
                   + FUSED_INGEST_GROUPS_DETAIL)
        self._randk = (self.comp is not None
                       and self.comp.name.startswith("randk"))
        self._efs = None   # EFStore, made in init() once d is known
        #: the programs by kind, shape and setting (CUDA graphs on CUDA),
        #: dropped by :meth:`clear_programs` (``repro_torch.clear_caches``)
        self._programs = {}
        register_programs(self)
        self.unravel = None
        self.codec = self.network = self.comm_log = None
        if network is not None and not fed.wire:
            raise ValueError(
                "a network was supplied but fed.wire is False — the "
                "transport simulation only runs in wire mode; set "
                "FedConfig(wire=True)")
        if fed.wire:
            name = fed.compressor if self.comp is not None else "dense32"
            self.codec = make_wire_codec(name, fed.compress_ratio,
                                         fed.wire_block, fed.wire_value_dtype)
            self._down_codec = (self.codec if fed.two_way
                                else make_dense32_codec())
            self.network = network or SimulatedNetwork(NetworkConfig(),
                                                       fed.num_clients)
            self.comm_log = CommLog()
        # event-driven buffered rounds: FedConfig has already pinned the
        # slice they run (wire, sparse uplink, no deadline/groups/ef_store)
        self._async = AsyncRoundEngine(self) if fed.async_buffer else None

    def init(self, params) -> SimState:
        """``params``: a nested dict of tensors in JAX shapes."""
        flat, self.unravel = ravel(params)
        flat = flat.to(self.device, torch.float32).clone()
        d = flat.numel()
        self._d = d
        bs, nb = block_layout(d, self.fed.wire_block)
        self._ingest_block = bs
        # selections carry padded-tail indices in [d, nb·bs), which the
        # scatter drops: validation accepts the padded domain, not [0, d)
        self._sel_domain = bs * nb
        m = self.fed.num_clients
        err_rows = m
        if self.fed.ef_store:
            # the (m, d) store lives host-side in lazy numpy shards; the
            # device holds the participating cohort's rows
            self._efs = EFStore(m, d)
            err_rows = self.fed.participating or m
        return SimState(
            params=flat,
            opt=init_server_state(flat, self.fed.server_state_dtype,
                                  self._ingest_block),
            errors=torch.zeros((err_rows, d), dtype=torch.float32,
                               device=self.device),
            server_error=torch.zeros(d, dtype=torch.float32,
                                     device=self.device),
            x_client=flat,
            bits=0,
            round=0,
        )

    def _bits_per_round(self, n: int) -> int:
        """Analytic one-way bits for one round (exact host-side int)."""
        if self.comp is not None:
            return n * int(self.comp.bits_per_message(self._d))
        return n * 32 * self._d

    def _round_timing(self, ids, round_idx: int):
        """Simulated-network timing draw for one round (host-side numpy,
        deterministic in (seed, round, client)); None outside wire mode."""
        if self.network is None:
            return None
        return self.network.round(ids, self.codec.nbytes(self._d),
                                  self._down_codec.nbytes(self._d), round_idx)

    def _record_timing(self, timing, finfo) -> dict:
        """Book one round's timing into the CommLog and return its metric
        entries. With two-level aggregation the uplink is billed per tier:
        n client messages (tier 1) plus g dense fp32 group partials pushed
        to the root (tier 2). A fault round books the planner's
        deadline-truncated wall-clock (so ``sim_time_s == Σ round_time_s``)
        and bills uplink bytes only for the clients whose payload arrived —
        delivered but rejected clients count (the wire carried their
        bytes)."""
        eff_time = delivered = None
        if finfo is not None:
            eff_time = finfo["round_time_s"]
            delivered = int(finfo["survivors"]) * self.codec.nbytes(self._d)
        g = self.fed.agg_groups
        return self.comm_log.record(timing,
                                    tier2_bytes=g * 4 * self._d if g > 1
                                    else 0,
                                    round_time_s=eff_time,
                                    delivered_uplink_bytes=delivered)

    def _host_to_device(self, client_batches, ids, fplan):
        """A round's batches (host arrays or tensors), its ids (host int64)
        and fault plan (or None) on the round's device."""
        with stage("host_to_device"):
            batches = {k: torch.as_tensor(v).to(self.device)
                       for k, v in client_batches.items()}
            rows = torch.as_tensor(ids, device=self.device)
            if fplan is not None:
                fplan = plan_to_device(fplan, self.device)
        return batches, rows, fplan

    def _eta_l(self, round_idx: int):
        """η_l of round ``round_idx`` (computed on the host) as a 0-d fp32
        tensor on the round's device, filled there."""
        return torch.full((), local_lr(self.fed, round_idx),
                          dtype=torch.float32, device=self.device)

    def _step_counts(self, rng, n: int):
        """The heterogeneous step counts of one round, drawn from ``rng``
        on the host, on the round's device; None when they are off."""
        k_all = hetero_step_counts(self.fed, rng, n)
        return None if k_all is None else k_all.to(self.device)

    def _draws(self, rng, n: int):
        """randk's positions for one round — (n + 2, k): the n clients'
        sets, γ's and the two-way downlink's — or None for every other
        compressor."""
        if not self._randk:
            return None
        k = max(1, int(round(self.comp.ratio * self._d)))
        return randk_positions(rng, self._d, k, n + 2, self.device)

    # -- one round ---------------------------------------------------------
    def round(self, state: SimState, client_batches, client_idx,
              rng: Optional[torch.Generator] = None, *, prefetch_idx=None):
        """``client_batches``: dict of arrays with leading (n, K, ...);
        ``client_idx``: (n,) distinct client ids (host array or tensor);
        ``rng``: a ``torch.Generator``, needed for heterogeneous step counts
        and randk's draws. The input state's EF buffer is updated in place;
        the returned state's other tensors and the metrics (0-d tensors on
        the state's device) are its own.

        The round is one program, as the reference jits its round: its
        host draws are staged as :meth:`run_rounds` stages them, then the
        round's body runs on the program of this shape and setting, kept
        with this FedSim (:meth:`_program`): on CUDA one CUDA graph,
        captured at the first call after a dropped warm-up run and replayed
        once a call; on the CPU the same body, run eagerly. The program
        adopts the first state's EF buffer as its slot (a state with
        another buffer, from another chain or a restore, is lent in:
        :meth:`_Program.load`). Inside
        :func:`repro_torch.disable_graphs` the round runs eagerly on the
        state itself (:meth:`_eager_round`).

        With ``fed.ef_store`` the round gathers the cohort's rows from the
        host store into the program's (n, d) block, runs over row
        *positions* (per-client batches and draws key off position already,
        so every row's math is bitwise the resident buffer's), and scatters
        the rows back; ``prefetch_idx`` (the NEXT round's ids) starts the
        background gather for round r+1 before this round's rows come
        back."""
        if self._async is not None:
            raise ValueError(
                "fed.async_buffer routes training through the event-driven "
                "buffered engine, which consumes ALL staged cohorts in one "
                "call — use run_rounds(...) (FederatedTrainer.run stages "
                "this automatically)")
        if isinstance(prefetch_idx, torch.Tensor):
            prefetch_idx = prefetch_idx.cpu().numpy()
        ids = _host_ids(client_idx)
        staged, timings, finfos = self._stage_rounds(
            state, {k: torch.as_tensor(v)[None]
                    for k, v in client_batches.items()}, ids[None], [rng])
        run = (self._program_round if graphs_enabled()
               else self._eager_round)
        new_state, met = run(state, staged, ids, prefetch_idx)
        bits = state.bits + self._bits_per_round(ids.size)
        return (new_state._replace(bits=bits, round=state.round + 1),
                self._book(met, bits, timings[0], finfos[0]))

    def _program_round(self, state: SimState, staged: _Staged, ids,
                       prefetch_idx):
        """:meth:`round` through its program: the state and the staged
        round loaded (with ``ef_store`` the cohort's rows gathered into the
        program's block), one run, the rows scattered back; the new state
        and the metrics as tensors of their own."""
        carry = _core(state)
        adopt = (2,)
        if self._efs is not None:
            with stage("ef_store"):
                held = torch.from_numpy(self._efs.gather(ids))
            carry = carry[:2] + (held,) + carry[3:]
            staged = staged._replace(
                idx=torch.arange(ids.size, device=self.device)[None])
            adopt = ()
        prog = self._program("round", carry, staged, adopt=adopt)
        prog.run(self)
        if self._efs is not None:
            with stage("ef_store"):
                if prefetch_idx is not None:
                    self._efs.prefetch(np.asarray(prefetch_idx))
                # the copy back waits for the round; the prefetch overlaps
                self._efs.scatter(ids, prog.carry[2].cpu().numpy())
        met = dict(zip(prog.keys, prog.out[:, 0].clone().unbind(0)))
        return SimState(*prog.result(), bits=0, round=0), met

    def _eager_round(self, state: SimState, staged: _Staged, ids,
                     prefetch_idx):
        """:meth:`round`'s body run eagerly on the state itself (inside
        :func:`repro_torch.disable_graphs`)."""
        at = lambda t: None if t is None else t[0]
        batches = {k: v[0] for k, v in staged.batches.items()}
        fplan = (None if staged.fplan is None
                 else FaultPlan(*(t[0] for t in staged.fplan)))
        cohort, rows = state, staged.idx[0]
        if self._efs is not None:
            with stage("ef_store"):
                held = torch.from_numpy(self._efs.gather(ids))
                cohort = state._replace(errors=held.to(self.device))
            rows = torch.arange(ids.size, device=self.device)
        with ops.rows_prechecked():
            new_state, met = self._round_impl(
                cohort, batches, rows, at(staged.eta_l), at(staged.k_all),
                fplan, at(staged.draws))
        if self._efs is not None:
            with stage("ef_store"):
                if prefetch_idx is not None:
                    self._efs.prefetch(np.asarray(prefetch_idx))
                # the copy back waits for the round; the prefetch overlaps
                self._efs.scatter(ids, new_state.errors.cpu().numpy())
        return new_state, met

    def _book(self, met: dict, bits: int, timing, finfo) -> dict:
        """A round's metrics, ``met`` (its device values), completed with
        its host counters: ``bits``, the wire timing booked into the
        CommLog, the fault verdicts. Both drivers book through here."""
        met["bits"] = bits
        if timing is not None:
            met.update(self._record_timing(timing, finfo))
        if finfo is not None:
            met["crashed"] = finfo["crashed"]
            met["deadline_cut"] = finfo["deadline_cut"]
        return met

    def run_rounds(self, state: SimState, client_batches, client_idx,
                   rngs=None):
        """R synchronous rounds as one program, as the reference's scan.
        ``client_batches``: leading (R, n, K, ...); ``client_idx``: (R, n);
        ``rngs``: R generators or None. Returns ``(new_state, mets)``, the
        per-round metric dicts :meth:`round` gives (``loss``, ``gamma`` and
        the fault counts as 0-d CPU tensors), bit for bit.

        Everything the rounds draw on the host is staged first
        (:meth:`_stage_rounds`); then one body (:meth:`_rounds_body`) runs
        round after round on a static copy of the state, reading its round's
        inputs at a round counter on the device. On CUDA the body is
        captured once into a ``torch.cuda.CUDAGraph`` (one per shape and
        setting, kept with this FedSim) and replayed R times, with no host
        work between replays and one host read of the stacked metrics at the
        end; on the CPU it runs eagerly. A capture or launch that fails
        raises. The input state is left as it was. Inside
        :func:`repro_torch.disable_graphs` the R rounds run one after
        another as :meth:`_eager_round`, building no program
        (:meth:`_eager_rounds`).

        With ``fed.ef_store`` each round's cohort rows move host↔device
        around the round, which no static carry holds, so the rounds are a
        loop of :meth:`round` (each one replay of its program) that
        prefetches the next round's rows. With
        ``fed.async_buffer`` the async engine consumes all R cohorts and
        returns one metric dict per FLUSH — ``ceil(deliveries / B)`` of them,
        not R."""
        if self._async is not None:
            return self._async.run(state, client_batches, client_idx, rngs)
        if self._efs is not None:
            mets = []
            R = len(client_idx)
            for r in range(R):
                b_r = {k: v[r] for k, v in client_batches.items()}
                state, met = self.round(
                    state, b_r, client_idx[r],
                    None if rngs is None else rngs[r],
                    prefetch_idx=client_idx[r + 1] if r + 1 < R else None)
                mets.append(met)
            return state, mets
        ids = _host_ids(client_idx)
        R, n = ids.shape
        staged, timings, finfos = self._stage_rounds(state, client_batches,
                                                     ids, rngs)
        if graphs_enabled():
            prog = self._program("rounds", _core(state), staged)
            prog.run(self, R)
            stacked = prog.out.to("cpu", copy=True)   # the one host read
            core = prog.result()
        else:
            core, stacked = self._eager_rounds(state, staged, ids)
        bpr = self._bits_per_round(n)
        mets = [self._book({key: stacked[j, r]
                            for j, key in enumerate(self._metric_keys())},
                           state.bits + bpr * (r + 1), timings[r], finfos[r])
                for r in range(R)]
        return SimState(*core, bits=state.bits + bpr * R,
                        round=state.round + R), mets

    def _eager_rounds(self, state: SimState, staged: _Staged, ids):
        """:meth:`run_rounds` inside :func:`repro_torch.disable_graphs`:
        R rounds of :meth:`_eager_round`, one after another, on a copy of
        the state (the input state is left as it was, as the program leaves
        it). Returns the final state's parts and the (keys, R) metrics on
        the host, as the program's slots hold them."""
        copy = lambda t: t.clone() if isinstance(t, torch.Tensor) else t
        cur = SimState(*pytree.tree_map(copy, _core(state)), bits=0, round=0)
        cols = []
        for r in range(ids.shape[0]):
            one = pytree.tree_map(
                lambda t: t[r:r + 1] if isinstance(t, torch.Tensor) else t,
                staged)
            cur, met = self._eager_round(cur, one, ids[r], None)
            cols.append(torch.stack([met[key].reshape(()).to(torch.float32)
                                     for key in self._metric_keys()]))
        return _core(cur), torch.stack(cols, 1).cpu()

    def _metric_keys(self) -> tuple:
        """The metrics a round computes on the device, in the order the
        round programs stack them."""
        return ("loss", "gamma") + (("survivors", "rejected")
                                    if self.faults is not None else ())

    def _stage_rounds(self, state: SimState, client_batches, ids, rngs):
        """What R rounds draw and read, made before the first of them, for
        both drivers (:meth:`round` stages its one round here): the ids
        ``(R, n)``, checked (distinct in each round, in ``[0, m)``), so the
        EF kernels' row checks are off in the rounds; each round's network
        timing and fault plan (host numpy, the plans stacked into (R, n)
        arrays); its step counts and randk's positions, drawn from
        ``rngs[r]`` in that order; η_l, computed on the host; and the
        batches. Returns ``(staged, timings, finfos)``: a :class:`_Staged`
        of (R, …)-leading tensors on the device, and the host-side timings
        and fault verdicts."""
        R, n = ids.shape
        self._check_ids(ids)
        timings = [self._round_timing(ids[r], state.round + r)
                   for r in range(R)]
        finfos = [None] * R
        plans = []
        if self.faults is not None:
            for r in range(R):
                p, finfos[r] = self.faults.plan(ids[r], state.round + r,
                                                timings[r])
                plans.append(p)
        with stage("host_to_device"):
            k_all, draws = [], []
            for r in range(R):
                rng = None if rngs is None else rngs[r]
                k_all.append(self._step_counts(rng, n))
                draws.append(self._draws(rng, n))
            eta_l = torch.tensor([local_lr(self.fed, state.round + r)
                                  for r in range(R)], dtype=torch.float32)
            staged = _Staged(
                batches={k: torch.as_tensor(v).to(self.device)
                         for k, v in client_batches.items()},
                idx=torch.from_numpy(ids).to(self.device),
                eta_l=eta_l.to(self.device),
                k_all=None if k_all[0] is None else torch.stack(k_all),
                draws=None if draws[0] is None else torch.stack(draws),
                fplan=(plan_to_device(stack_plans(plans), self.device)
                       if plans else None))
        return staged, timings, finfos

    def _check_ids(self, ids: np.ndarray) -> None:
        """``ids`` (R, n): distinct in each round and in ``[0, m)``,
        checked on the host, so the EF kernels' row checks can be off."""
        m = self.fed.num_clients
        for row in ids:
            if np.unique(row).size != row.size:
                raise ValueError("client_idx must hold distinct client ids")
        if ids.size and (ids.min() < 0 or ids.max() >= m):
            raise ValueError(f"client_idx must lie in [0, {m})")

    def _program(self, kind: str, carry, inputs, adopt=()) -> "_Program":
        """The program of ``kind`` — ``"rounds"`` (:meth:`run_rounds`),
        ``"round"`` (:meth:`round`), ``"dispatch"`` or ``"flush"`` (the
        async engine's steps) — for these shapes and the settings that
        pick kernels (deterministic algorithms, TF32), made on first use
        and kept; loaded with ``carry`` and ``inputs``. A program that
        adopts the caller's tensors (``adopt``) keeps its first caller's
        there and lends another caller's in (:meth:`_Program.load`)."""
        key = (kind, _shapes(carry), _shapes(inputs),
               str(pytree.tree_structure(inputs)),
               torch.are_deterministic_algorithms_enabled(),
               torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        prog = self._programs.get(key)
        if prog is None:
            if kind in ("round", "rounds"):
                name, R = "_rounds_body", inputs.idx.shape[0]
                keys = self._metric_keys()
            else:
                name, R, keys = f"_{kind}_body", 1, ()
            prog = self._programs[key] = _Program(name, carry, inputs, keys,
                                                  R, self.device, adopt)
        prog.load(carry, inputs)
        return prog

    def clear_programs(self) -> None:
        """Drops every program this FedSim has built (its graphs, pools,
        static inputs and carry copies; an adopted EF buffer stays its
        state's): ``repro_torch.clear_caches``. The next call builds its
        program again."""
        self._programs.clear()

    def _rounds_body(self, prog: "_Program"):
        """One round of :meth:`run_rounds`: round ``prog.ctr``'s inputs,
        :meth:`_round_impl` on the static carry, the new state written back
        into it (the EF buffer is updated in place, as the reference's
        donated carry), the metrics into their slot, and the counter
        advanced. No host read: every value that varies by round is read on
        the device."""
        st, ctr = prog.inputs, prog.ctr
        at = lambda t: None if t is None else t.index_select(0, ctr)[0]
        fplan = (None if st.fplan is None
                 else FaultPlan(*(at(t) for t in st.fplan)))
        state = SimState(*prog.carry, bits=0, round=0)
        with ops.rows_prechecked():
            new, met = self._round_impl(
                state, {k: at(v) for k, v in st.batches.items()},
                at(st.idx), at(st.eta_l), at(st.k_all), fplan, at(st.draws))
        if set(met) != set(prog.keys):
            raise RuntimeError(f"run_rounds: the round's metrics {sorted(met)}"
                               f" are not the program's {prog.keys}")
        prog.write(_core(new), met)

    def _train_block(self, flat0, batches, eta_l, k_blk=None):
        """Local training for a block of clients → ((c, d) deltas, (c,)
        losses): one ``torch.func.vmap`` program over the block
        (``core.local.train_clients``), as the reference vmaps
        ``_local_train``. A ``loss_fn`` torch.func cannot take raises
        here, naming the cause; there is no fallback to a loop over the
        clients."""
        try:
            return train_clients(self.rule,
                                 func_grad_fn(self.loss_fn, self.unravel),
                                 flat0, batches, eta_l, k_blk)
        except RuntimeError as e:
            cause = _vmap_refusal(e)
            if cause is None:
                raise
            raise RuntimeError(
                f"FedSim trains each block of clients as one torch.func.vmap "
                f"program (its gradient by torch.func.grad_and_value), and "
                f"torch.func cannot take this loss_fn: {cause}.\n{e}") from e

    def _fault_round(self, state: SimState, batches, client_idx, eta_l,
                     k_all, fplan, draws=None):
        """Fault-tolerant round: every client trains and uplinks as usual —
        the damage is in transit — then the server masks the aggregate down
        to the validated survivors.

        * The client books its EF residual against the CLEAN decoded value
          it sent; corruption comes after. The uplink updates the cohort's
          EF rows in place, so their pre-round copy is taken first, and the
          rows of clients the server does not ingest (crashed, cut at the
          deadline, rejected) are restored from it — the stale residual
          they repay on rejoin, ``where(surv, new_rows, old_rows)`` in JAX.
        * Validation runs before ingest: NaN/Inf and out-of-range indices
          zero the offender's contribution and drop it from the survivor
          count, so one poisoned payload cannot reach m/v/v̂.
        * With an all-ones plan this is bitwise the fault-free round on the
          two-pass server path.
        """
        fed = self.fed
        fcfg = self.faults.cfg
        mode = fcfg.corrupt_mode
        corrupting = fcfg.corrupt_prob > 0
        flat0 = state.x_client
        d = flat0.numel()
        n = client_idx.numel()
        with stage("local_training"):
            delta, losses = self._train_block(flat0, batches, eta_l, k_all)
            # the cohort mean: every client trained, delivered or not
            loss = losses.mean()
        errors = state.errors
        with stage("uplink"):
            old_rows = (errors[client_idx] if self.comp is not None
                        else None)
            if self.sparse:
                vals, sidx = client_uplink_sparse(self.comp, errors,
                                                  client_idx, delta,
                                                  self._ingest_block,
                                                  self.codec)
            else:
                hats = client_uplink(self.comp, self.codec, d, delta, errors,
                                     client_idx,
                                     None if draws is None else draws[:n])
        with stage("validate"):
            if self.sparse:
                rx, ridx = (corrupt_selection(vals, sidx, fplan, mode)
                            if corrupting else (vals, sidx))
                rx, valid = validate_selection(rx, ridx, self._sel_domain,
                                               fcfg.max_update_norm)
            else:
                rx = corrupt_dense(hats, fplan, mode) if corrupting else hats
                truncated = (fplan.corrupt
                             if corrupting and mode == "truncate" else None)
                rx, valid = validate_dense(rx, fcfg.max_update_norm,
                                           truncated)
            surv = fplan.survivors * valid
            if old_rows is not None:
                errors.index_copy_(0, client_idx, torch.where(
                    surv[:, None] > 0, errors[client_idx], old_rows))
        with stage("server_aggregate"):
            if self.sparse:
                agg = server_aggregate_sparse_masked(rx, ridx, d, surv)
            else:
                agg = (torch.where(surv[:, None] > 0, rx, 0.0).sum(dim=0)
                       / surv.sum().clamp_min(1.0))
        with stage("server_update"):
            new_flat, opt = server_update(fed, state.opt, state.params, agg)
        with stage("downlink"):
            x_client, server_error = server_downlink(
                fed, self.comp, self.codec, new_flat, state.x_client,
                state.server_error, None if draws is None else draws[n + 1])
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        met = {"loss": loss, "gamma": zero, "survivors": surv.sum(),
               "rejected": (fplan.survivors * (1.0 - valid)).sum()}
        return (state._replace(params=new_flat, opt=opt, errors=errors,
                               server_error=server_error, x_client=x_client),
                met)

    def _chunked_clients(self, errors, batches, client_idx, flat0, eta_l,
                         k_all, draws):
        """The client half of a ``client_chunk`` round: the cohort trains
        and uplinks ``client_chunk`` clients at a time, so the deltas, hats
        and EF totals in flight are (cc, d), not (n, d). The sparse path
        scatters each chunk's ``(vals, idx)`` into a running (d + 1,) sum in
        client order (bitwise the unchunked scatter-mean), or, with
        ``agg_groups > 1`` (chunk == group), into a fresh partial per chunk
        that the running sum then adds (bitwise
        ``server_aggregate_sparse_grouped``); the dense path sums the
        chunks' hats. Returns ``(agg, losses, mean_tot, mean_delta)``; the
        means of the EF totals and of the deltas (for γ) are summed chunk
        by chunk under ``track_gamma`` only, else None."""
        fed = self.fed
        n = client_idx.numel()
        cc = fed.client_chunk
        d = flat0.numel()
        zeros = lambda size: torch.zeros(size, dtype=torch.float32,
                                         device=flat0.device)
        track = fed.track_gamma and self.comp is not None
        s_hat = zeros(d + 1 if self.sparse else d)
        s_tot, s_delta = (zeros(d), zeros(d)) if track else (None, None)
        losses = []
        for c0 in range(0, n, cc):
            part = slice(c0, c0 + cc)
            rows = client_idx[part]
            with stage("local_training"):
                delta, loss_c = self._train_block(
                    flat0, {k: v[part] for k, v in batches.items()}, eta_l,
                    None if k_all is None else k_all[part])
            with stage("uplink"):
                if track:
                    s_tot += (errors[rows] + delta).sum(dim=0)
                    s_delta += delta.sum(dim=0)
                if self.sparse:
                    vals, sidx = client_uplink_sparse(
                        self.comp, errors, rows, delta, self._ingest_block,
                        self.codec)
                else:
                    hats = client_uplink(
                        self.comp, self.codec, d, delta, errors, rows,
                        None if draws is None else draws[part])
            with stage("server_aggregate"):
                if not self.sparse:
                    s_hat += hats.sum(dim=0)
                elif fed.agg_groups > 1:
                    s_hat += scatter_add_clients(zeros(d + 1), vals, sidx)
                else:
                    scatter_add_clients(s_hat, vals, sidx)
            losses.append(loss_c)
        agg = ref.div_rn(s_hat, n)[:d]
        if not track:
            return agg, torch.cat(losses), None, None
        return (agg, torch.cat(losses), ref.div_rn(s_tot, n),
                ref.div_rn(s_delta, n))

    def _round_impl(self, state: SimState, batches, client_idx, eta_l,
                    k_all, fplan=None, draws=None):
        """One round on the device: ``eta_l`` a 0-d fp32 tensor, ``k_all``
        the (n,) step counts on the device or None, ``fplan`` a device
        plan or None, ``draws`` randk's (n + 2, k) positions or None.
        Returns ``(state, met)``, ``met`` holding 0-d device tensors; the
        host counters are the caller's."""
        if fplan is not None:
            return self._fault_round(state, batches, client_idx, eta_l,
                                     k_all, fplan, draws)
        fed = self.fed
        n = client_idx.numel()
        flat0 = state.x_client
        d = flat0.numel()
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        errors = state.errors
        cc = fed.client_chunk
        if cc and 0 < cc < n and n % cc:   # n may differ from the
            # configured count __init__ checked against
            raise ValueError(
                f"client_chunk={cc} does not divide this round's client "
                f"count n={n} — refusing to silently fall back to the "
                f"full (n, d) vmap")
        if cc and 0 < cc < n:
            agg, losses, mean_tot, mean_delta = self._chunked_clients(
                errors, batches, client_idx, flat0, eta_l, k_all, draws)
            loss = losses.mean()
        else:
            with stage("local_training"):
                delta, losses = self._train_block(flat0, batches, eta_l,
                                                  k_all)
                loss = losses.mean()
            mean_tot = mean_delta = None
            with stage("uplink"):
                if fed.track_gamma and self.comp is not None:
                    # the diagnostic needs the EF totals before the uplink
                    mean_tot = (errors[client_idx] + delta).mean(dim=0)
                    mean_delta = delta.mean(dim=0)
                if self.sparse:
                    vals, sidx = client_uplink_sparse(self.comp, errors,
                                                      client_idx, delta,
                                                      self._ingest_block,
                                                      self.codec)
                else:
                    hats = client_uplink(self.comp, self.codec, d, delta,
                                         errors, client_idx,
                                         None if draws is None
                                         else draws[:n])
            if self.sparse and self._fused != "off":
                # one-pass fused ingest: the selections go straight into
                # the m/v/v̂/x update, no dense mean delta
                with stage("server_ingest"):
                    new_flat, opt = server_ingest(
                        fed, state.opt, state.params, vals, sidx, n,
                        block=self._ingest_block, impl=self._fused)
                with stage("downlink"):
                    x_client, server_error = server_downlink(
                        fed, self.comp, self.codec, new_flat, state.x_client,
                        state.server_error)
                return (state._replace(params=new_flat, opt=opt,
                                       errors=errors,
                                       server_error=server_error,
                                       x_client=x_client),
                        {"loss": loss, "gamma": zero})
            with stage("server_aggregate"):
                if not self.sparse:
                    agg = hats.mean(dim=0)
                elif fed.agg_groups > 1:
                    agg = server_aggregate_sparse_grouped(vals, sidx, d, n,
                                                          fed.agg_groups)
                else:
                    agg = server_aggregate_sparse(vals, sidx, d, n)
        with stage("gamma"):
            gamma = (gamma_diagnostic(self.comp, mean_tot, agg, mean_delta,
                                      None if draws is None else draws[n])
                     if fed.track_gamma else zero)
        with stage("server_update"):
            new_flat, opt = server_update(fed, state.opt, state.params, agg)
        with stage("downlink"):
            x_client, server_error = server_downlink(
                fed, self.comp, self.codec, new_flat, state.x_client,
                state.server_error, None if draws is None else draws[n + 1])
        return (state._replace(params=new_flat, opt=opt, errors=errors,
                               server_error=server_error, x_client=x_client),
                {"loss": loss, "gamma": gamma})

    # -- async buffered engine steps ------------------------------------------
    def _dispatch(self, errors, x_client, batches, client_idx, round_idx,
                  k_all, fplan=None):
        """The engine's dispatch (:meth:`_async_dispatch`) as one program
        per shape and setting, as the reference jits it with the EF buffer
        donated: the program adopts ``errors`` (updated in place) and takes
        the model, the batches, the ids (checked by the engine on the
        host), η_l, the step counts and the fault plan as static inputs.
        Returns the payloads ``(vals, idx, losses)`` as tensors of their
        own. Inside :func:`repro_torch.disable_graphs`: the eager step."""
        if not graphs_enabled():
            return self._async_dispatch(errors, x_client, batches,
                                        client_idx, round_idx, k_all, fplan)
        inputs = (x_client, batches, client_idx, self._eta_l(round_idx),
                  None if k_all is None else k_all.to(self.device), fplan)
        prog = self._program("dispatch", (errors,), inputs, adopt=(0,))
        return tuple(t.clone() for t in prog.run(self))

    def _dispatch_body(self, prog: "_Program"):
        x_client, batches, rows, eta_l, k_all, fplan = prog.inputs
        with ops.rows_prechecked():
            return self._dispatch_impl(prog.carry[0], x_client, batches,
                                       rows, eta_l, k_all, fplan)

    def _flush(self, state: SimState, vals, idx, w, fill, losses):
        """The engine's flush (:meth:`_async_flush`) as one program per
        shape and setting, as the reference jits it with the server state
        donated: the server's x and m/v/v̂ are its carry, the (B, k) buffer,
        the weights, the fill and the losses its static inputs (a partial
        flush has the same shapes). Returns ``(state, met)``, the new state
        and the metrics tensors of their own. Inside
        :func:`repro_torch.disable_graphs`: the eager step."""
        if not graphs_enabled():
            return self._async_flush(state, vals, idx, w, fill, losses)
        prog = self._program("flush", (state.params, state.opt),
                             (vals, idx, w, fill, losses))
        met = {k: v.clone() for k, v in prog.run(self).items()}
        params, opt = prog.result()
        return state._replace(params=params, opt=opt, x_client=params), met

    def _flush_body(self, prog: "_Program"):
        params, opt = prog.carry
        new, met = self._async_flush(
            SimState(params, opt, None, None, None, 0, 0), *prog.inputs)
        for dst, src in zip(_tensors(prog.carry),
                            _tensors((new.params, new.opt))):
            if dst is not src:
                dst.copy_(src)
        return met

    def _async_dispatch(self, errors, x_client, batches, client_idx,
                        round_idx, k_all, fplan=None):
        """Client side of one async cohort: train and take the select-once
        sparse uplink against the CURRENT server model, EF booked at
        dispatch in the resident buffer (in place). Without faults this is
        the sync round's client half; with them it is
        :meth:`_fault_round`'s: the damage comes after the EF books the
        clean residual, and a client whose payload will be rejected (or who
        crashed) gets its pre-dispatch row back, to repay on its next
        dispatch — the verdict is a function of the payload, so the flush's
        re-validation agrees with it. Returns ``(vals, idx, losses)``, the
        payloads the engine schedules for delivery (validated at the
        flush)."""
        return self._dispatch_impl(errors, x_client, batches, client_idx,
                                   self._eta_l(round_idx), k_all, fplan)

    def _dispatch_impl(self, errors, x_client, batches, client_idx, eta_l,
                       k_all, fplan=None):
        """:meth:`_async_dispatch` with η_l a 0-d tensor."""
        with stage("local_training"):
            delta, losses = self._train_block(x_client, batches, eta_l,
                                              k_all)
        with stage("uplink"):
            old_rows = errors[client_idx] if fplan is not None else None
            vals, sidx = client_uplink_sparse(self.comp, errors, client_idx,
                                              delta, self._ingest_block,
                                              self.codec)
        if fplan is None:
            return vals, sidx, losses
        fcfg = self.faults.cfg
        with stage("validate"):
            if fcfg.corrupt_prob > 0:
                vals, sidx = corrupt_selection(vals, sidx, fplan,
                                               fcfg.corrupt_mode)
            _, valid = validate_selection(vals, sidx, self._sel_domain,
                                          fcfg.max_update_norm)
            surv = fplan.survivors * valid
            errors.index_copy_(0, client_idx, torch.where(
                surv[:, None] > 0, errors[client_idx], old_rows))
        return vals, sidx, losses

    def _async_flush(self, state: SimState, vals, idx, w, fill, losses):
        """Server side of one buffered flush: ingest a fixed-shape (B, k)
        buffer. ``w``: (B,) staleness weight × fill; ``fill``: (B,) 1.0 on
        occupied slots (a partial flush's empty slots hold idx = 0, vals =
        +0.0, w = 0). With faults armed the buffer is validated again
        (NaN/Inf or out-of-range payloads get weight 0). The fused path
        folds the weighted mean into the ingest's ``/B`` by the pre-scale
        ``w·B/max(Σw, 1)`` — exactly 1.0 at unit weights, so the
        buffer == cohort anchor stays bitwise on the fused path too — and
        runs ``fedams_ingest``; otherwise the weighted scatter-mean and
        ``server_update`` (``fedams_update``). Returns ``(state, met)``."""
        fed = self.fed
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        rejected = zero
        if self.faults is not None:
            fcfg = self.faults.cfg
            with stage("validate"):
                vals, valid = validate_selection(vals, idx, self._sel_domain,
                                                 fcfg.max_update_norm)
                rejected = torch.where(w > 0, 1.0 - valid, 0.0).sum()
                w = w * valid
        # the loss over ingested entries only (fill-masked mean)
        loss = (losses * fill).sum() / fill.sum().clamp_min(1.0)
        if self._fused != "off":
            b = vals.shape[0]
            with stage("server_ingest"):
                scale = w * (torch.full((), b, dtype=torch.float32,
                                        device=w.device)
                             / w.sum().clamp_min(1.0))
                svals = torch.where(w[:, None] > 0, vals, 0.0) * scale[:, None]
                new_flat, opt = server_ingest(fed, state.opt, state.params,
                                              svals, idx, b,
                                              block=self._ingest_block,
                                              impl=self._fused)
        else:
            with stage("server_aggregate"):
                agg = server_aggregate_sparse_weighted(vals, idx, self._d, w)
            with stage("server_update"):
                new_flat, opt = server_update(fed, state.opt, state.params,
                                              agg)
        # two_way is refused with async (FedConfig): the clients see the
        # exact new model
        met = {"loss": loss, "gamma": zero, "rejected": rejected,
               "weight_sum": w.sum()}
        return state._replace(params=new_flat, opt=opt,
                              x_client=new_flat), met
