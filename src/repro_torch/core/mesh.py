"""The mesh backend on ``torch.distributed``.

Counterpart of ``repro.core.mesh``. ``build_fed_round`` returns the
per-rank round body ``fed_round(state, batch, seed)``: every rank is one
process, each index of the client axes IS one client (one client per
client-axis rank, as in JAX), and FedCAMS compression applies to the
client-axis collective (dense psum, or the sparse / packed aggregation of
``core.stages.mesh_uplink``). Each rank holds its client's EF row; the
server state is replicated, or sharded ZeRO-style over the state-shard
axes (``shard_server_state``). The local phase runs the configured
``core.local`` rule with plain per-rank autograd: nothing reduces
gradients across clients (no DDP, no hook), which is what JAX's ``pvary``
of the params achieves; with ``"data"`` not a client axis (within-client
data parallelism) the gradient is all-reduced over the data axis
explicitly and divided by ``dp``, as JAX's automatic psum over ``"data"``.

Every rank calls ``fed_round`` with the same ``seed``: the round's shared
draws (participation, heterogeneous step counts, fault masks, randk
positions) come from CPU generators seeded by it
(``core.sampling.round_generator``), so every rank draws the same numbers
with no collective — the role of JAX's shared per-round key, not its
streams. The state is per rank (``FedMeshState``: the params, this rank's
slices of m/v/v̂ and its client's EF row); :func:`shard_fed_state` and
:func:`gather_fed_state` convert to and from the global layout the JAX
package holds (``convert.mesh_state_to_jax`` / ``mesh_state_from_jax``
carry that across packages). With a model axis (``tp > 1``) the params
and every state leaf are this rank's model shards (``ParamDef`` specs
naming ``"model"``): each rank selects, gathers over the client axes and
ingests its own model-local leaves, and the model's backward sums the
replicated weights' gradients over the model axis (``models.layers``); a
replicated leaf's local update is model rank 0's on every model rank
(:func:`sync_model_replicas`), so its copies never drift apart.

Many rounds, one program (:func:`build_fed_rounds_scan`, the reference's
``lax.scan`` of the round): the host draws of R rounds are staged first
(:meth:`MeshRound.stage_inputs`, which the eager round runs at R = 1),
then the round body runs round after round on the state's own tensors,
reading its round's slot at a round counter on the device; on CUDA +
NCCL one round is captured into a CUDA graph and replayed R times. The
per-round step the trainer and ``launch.train`` take a round at a time
(the reference jits it) is the same program at R = 1
(:meth:`MeshRounds.round`), one kept across the calls; ``fed_round``
itself stays the eager round, the reference's un-jitted ``rnd``.

A model is duck-typed as the JAX one: ``defs()`` (a nested dict of
``ParamDef``), ``loss(p, b, ctx, remat_policy=..., chunk=...) -> (loss,
aux)``, ``train_batch_defs(global_batch, seq_len)`` and ``tp``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import graphs_enabled, register_programs, resolve_device
from repro_torch.comm.faults import (FaultPlan, corrupt_selection,
                                     mesh_corruption_plan, mesh_fault_mask)
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.core.compressors import (Selection, block_layout,
                                          make_compressor)
from repro_torch.core.local import (hetero_step_counts, local_lr,
                                    make_local_update, run_local_steps)
from repro_torch.core.sampling import participation_mask, round_generator
from repro_torch.core.server_opt import (FUSED_INGEST_GROUPS_DETAIL,
                                         ServerState, server_ingest_tree,
                                         server_update_tree)
from repro_torch.core.stages import (mesh_agg_strategy, mesh_select_tree,
                                     mesh_uplink, randk_leaf_positions,
                                     resolve_fused_ingest,
                                     resolve_mesh_sparse_impl,
                                     sparse_topk_leaf_validated, stage)
from repro_torch.kernels import ops
from repro_torch.models import params as pdefs
from repro_torch.models.params import tree_leaves, tree_map, tree_unzip

class FedMeshState(NamedTuple):
    """One rank's federated state. In the global layout
    (:func:`gather_fed_state`, the JAX package's ``FedMeshState``) every
    leaf has its global shape: ``errors`` leaves lead with the client dim
    (m, ...), ``m``/``v``/``vhat`` are whole."""
    params: object     # nested dict, this rank's model shards
    m: object          # server momentum (fp32; this rank's shard if sharded)
    v: object          # server variance (fp32 or bf16)
    vhat: object       # max-stabilized variance
    errors: object     # this rank's client's EF row: leaves (1, *shape)
    round: torch.Tensor   # int32 0-d


def client_batch_axes(fed: FedConfig) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    axes = tuple(fed.client_axes)
    if "data" not in axes:
        axes = axes + ("data",)
    return axes


def state_shard_axes(fed: FedConfig):
    """Mesh axes the server state shards over (ZeRO mode)."""
    return tuple(fed.client_axes) if fed.client_axes else ("data",)


def state_shard_dim(dref: pdefs.ParamDef, shards: int):
    """First dim of a leaf that can host the server-state shard, or None:
    an unsharded dim its spec covers, as the reference's ``zip(shape,
    spec)`` reads it (a spec shorter than the shape, like the sLSTM's
    ``()``, covers its leading dims only). ``spec=None`` covers every dim
    (ROADMAP Queue 3 item 11)."""
    if shards <= 1:
        return None
    specs = dref.dim_specs if dref.spec is None else tuple(dref.spec)
    for i, (size, sp) in enumerate(zip(dref.shape, specs)):
        if sp is None and size % shards == 0 and size >= shards:
            return i
    return None


def _axes_spec(axes):
    return axes[0] if len(axes) == 1 else tuple(axes)


def fed_state_defs(model, fed: FedConfig) -> FedMeshState:
    """ParamDef tree for the full federated state (GLOBAL shapes)."""
    par = model.defs()

    def opt_leaf(dref: pdefs.ParamDef) -> pdefs.ParamDef:
        dref = dataclasses.replace(dref, dtype="float32")
        if fed.shard_server_state:
            sd = state_shard_dim(dref, fed.state_shards)
            if sd is not None:
                spec = list(dref.dim_specs)
                spec[sd] = _axes_spec(state_shard_axes(fed))
                dref = dataclasses.replace(dref, spec=tuple(spec))
        return dref

    def client_stacked(dref: pdefs.ParamDef) -> pdefs.ParamDef:
        ax = _axes_spec(fed.client_axes) if fed.client_axes else None
        return dataclasses.replace(
            dref, shape=(fed.num_clients,) + tuple(dref.shape),
            spec=(ax,) + dref.dim_specs, dtype="float32")

    opt = tree_map(opt_leaf, par)
    # second-moment storage dtype (m always stays fp32): bf16 halves the
    # v/v̂ residency; int8-blockscale has no mesh ParamDef form
    if fed.server_state_dtype == "int8":
        raise ValueError(
            "FedConfig.server_state_dtype='int8' is simulation-only — the "
            "blockscale QuantState layout has no mesh ParamDef form; use "
            "'bfloat16' on the mesh backend")
    if fed.server_state_dtype == "bfloat16":
        second = tree_map(
            lambda dref: dataclasses.replace(dref, dtype="bfloat16"), opt)
    else:
        second = opt
    errors = tree_map(client_stacked, par)
    return FedMeshState(
        params=par, m=opt, v=second, vhat=second, errors=errors,
        round=pdefs.ParamDef((), dtype="int32", init="zeros"))


# -- global <-> per-rank layouts ---------------------------------------------


def _state_map(fn, state: FedMeshState, defs: FedMeshState) -> FedMeshState:
    return FedMeshState(*(tree_map(fn, s, d) for s, d in zip(state, defs)))


def shard_fed_state(state: FedMeshState, model, fed: FedConfig, ctx,
                    device=None) -> FedMeshState:
    """A global-layout state (every rank holding the same one) → this
    rank's state on ``device`` (None: CUDA): its client's EF row, its slice of each
    sharded m/v/v̂ leaf."""
    defs = fed_state_defs(model, fed)
    device = resolve_device(device)
    return _state_map(
        lambda t, d: pdefs.take_shard(t, d, ctx).to(
            device=device, copy=True).contiguous(), state, defs)


def gather_fed_state(state: FedMeshState, model, fed: FedConfig,
                     ctx) -> FedMeshState:
    """This rank's state → the global layout, on every rank (collective:
    every rank calls it). EF rows come back client-major."""
    defs = fed_state_defs(model, fed)
    return _state_map(lambda t, d: pdefs.gather_shard(t, d, ctx), state,
                      defs)


def _mesh_sizes(ctx) -> dict:
    """Every named dim of the mesh → its size, as ``take_shard`` cuts
    leaves (the ZeRO state shards over "data" with no client axes)."""
    if ctx.mesh is None:
        return {}
    return {ax: ctx.axis_size((ax,)) for ax in ctx.mesh.mesh_dim_names}


def init_fed_state(model, fed: FedConfig, generator: torch.Generator, ctx,
                   device=None) -> FedMeshState:
    """This rank's initial state: params from ``generator`` (the global
    tree, the same on every rank given the same seed, cut to this rank's
    model shards: ``models.params.init_params``), zeros elsewhere, each
    leaf in its per-rank shape, on ``device`` (None: CUDA)."""
    device = resolve_device(device)
    defs = fed_state_defs(model, fed)
    params = pdefs.init_params(defs.params, generator, device, ctx=ctx)
    sizes = _mesh_sizes(ctx)
    zeros = lambda t: tree_map(
        lambda d: torch.zeros(pdefs.local_shape(d, sizes),
                              dtype=getattr(torch, d.dtype), device=device),
        t)
    return FedMeshState(params=params, m=zeros(defs.m), v=zeros(defs.v),
                        vhat=zeros(defs.vhat), errors=zeros(defs.errors),
                        round=torch.zeros((), dtype=torch.int32,
                                          device=device))


def _sharded_server_update(fed: FedConfig, st: ServerState, params, agg,
                           model, ctx):
    """ZeRO-style server step: each index along the state-shard axes owns a
    slice of (m, v, v̂); it updates its slice of x from its slice of the
    aggregate and the refreshed params are all-gathered back along the
    shard dim, client-major. Leaves too small to shard stay replicated and
    update normally."""
    axes = state_shard_axes(fed)
    shards = fed.state_shards
    idx = ctx.axis_index(axes)
    dims = tree_map(lambda d: state_shard_dim(d, shards), model.defs())

    def take(leaf, sd):
        if sd is None:
            return leaf
        chunk = leaf.shape[sd] // shards
        return leaf.narrow(sd, idx * chunk, chunk)

    newp_sh, new_st = server_update_tree(fed, st, tree_map(take, params, dims),
                                         tree_map(take, agg, dims))

    def gather(newp, oldp, sd):
        if sd is None:
            return newp
        return ctx.gather_axes(axes, newp, axis=sd).to(oldp.dtype)

    return tree_map(gather, newp_sh, params, dims), new_st


# -- the round ---------------------------------------------------------------


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def leaf_wire_bytes(fed: FedConfig, dl: int, block: int = 2048) -> int:
    """Per-client collective payload bytes for ONE leaf of ``dl`` local
    elements, resolved through the same ``mesh_agg_strategy`` the round
    executes (every fallback billed as the dense psum it runs):

    * ``sparse_topk`` / ``sparse_topk_hier`` — the gathered Selection: an
      int32 index + fp32 value per kept coordinate (8 bytes each), ``nb·kb``
      entries in the leaf's padded block layout (on the hierarchical
      strategy the TIER-1 payload; the tier-2 partial is
      :func:`leaf_tier2_bytes`);
    * ``packed_sign``  — the 8→1 packed sign bits + one fp32 scale;
    * ``dense``        — ``delta_dtype`` words for every element.
    """
    strategy = mesh_agg_strategy(fed)
    if strategy in ("sparse_topk", "sparse_topk_hier"):
        bs, nb = block_layout(dl, block)
        kb = max(1, int(round(fed.compress_ratio * bs)))
        return nb * kb * 8                # int32 index + fp32 value
    if strategy == "packed_sign":
        return (dl + 7) // 8 + 4          # 1 bit/coord + fp32 scale
    return dl * _itemsize(fed.delta_dtype)


def leaf_tier2_bytes(fed: FedConfig, dl: int) -> int:
    """Per-GROUP root-collective payload bytes for one leaf: the dense fp32
    group partial ``sparse_topk_hier_leaf`` gathers over the group axis.
    Zero on every flat strategy."""
    if mesh_agg_strategy(fed) == "sparse_topk_hier":
        return dl * 4
    return 0


def _numels(delta_tree):
    return [int(np.prod(tuple(leaf.shape))) for leaf in tree_leaves(delta_tree)]


def mesh_wire_bytes(fed: FedConfig, delta_tree, block: int = 2048,
                    tp: int = 1) -> int:
    """Per-client contribution bytes for one mesh round's client-axis
    collective: the sum of :func:`leaf_wire_bytes` over this rank's leaf
    tree (``delta_tree``: tensors or arrays), × ``tp`` (each of a client's
    model-parallel ranks pushes its own payload). On the hierarchical
    strategy this is the TIER-1 contribution."""
    return sum(leaf_wire_bytes(fed, n, block)
               for n in _numels(delta_tree)) * max(tp, 1)


def mesh_wire_bytes_tiers(fed: FedConfig, delta_tree, block: int = 2048,
                          tp: int = 1) -> dict:
    """Per-tier uplink bytes for one mesh round: ``tier1`` the per-CLIENT
    payload (:func:`mesh_wire_bytes`, pushed by each of m clients),
    ``tier2`` the per-GROUP dense partial (g pushes; 0 on flat
    strategies). The round's ``wire_up_bytes`` is ``m·tier1 + g·tier2``."""
    tier2 = sum(leaf_tier2_bytes(fed, n) for n in _numels(delta_tree))
    return {"tier1": mesh_wire_bytes(fed, delta_tree, block, tp),
            "tier2": tier2 * max(tp, 1)}


def sync_model_replicas(delta, defs, ctx):
    """Make each leaf of ``delta`` that no dim shards over the model axis
    model rank 0's on every model rank, in place (one broadcast of their
    concatenation). Every model rank computes such a leaf's local update
    itself, and on a card the replicated compute need not round alike on
    every rank (cuBLAS's and a scatter's orders of sums): the same update
    keeps every model rank's copy of the leaf, its EF row and its selection
    the same to the bit, as the reference's are by construction. On the
    CPU the copies already agree and this changes no bit."""
    if not ctx.model_axis or ctx.tp <= 1:
        return
    reps = [t for t, d in zip(tree_leaves(delta), tree_leaves(defs))
            if not any(ctx.model_axis in pdefs.dim_axes(sp)
                       for sp in d.dim_specs)]
    if not reps:
        return
    flat = ctx.broadcast_model(torch.cat([t.reshape(-1) for t in reps]))
    for t, part in zip(reps, torch.split(flat, [t.numel() for t in reps])):
        t.copy_(part.view_as(t))


class MeshRoundInputs(NamedTuple):
    """What R mesh rounds draw or compute on the host, made before the
    first of them (:meth:`MeshRound.stage_inputs`) and stacked on the
    state's device, each leading with R. The round body reads its round's
    slot of them and nothing else from the host."""
    eta_l: torch.Tensor                # (R,) fp32 local learning rates
    k_i: Optional[torch.Tensor]        # (R,) int64 this rank's step counts
    mask: torch.Tensor                 # (R, m) fp32 participation × alive
    plan: Optional[FaultPlan]          # (R, 1) this rank's corruption row
    randk: Optional[dict]              # per leaf (R, k_leaf) int64 positions


class MeshRound:
    """This rank's mesh round (:func:`build_fed_round`): calling it,
    ``fed_round(state, batch, seed) -> (state, metrics)``, runs one round
    eagerly. Its two halves are shared with :func:`build_fed_rounds_scan`:
    :meth:`stage_inputs`, the host prelude that makes every value a round
    takes from the host for R rounds at once, and :meth:`body`, the round
    on the device from its slot of those values. A call is the prelude at
    R = 1 and the body on slot 0, so the eager round and the program run
    one round."""

    def __init__(self, stage_inputs, body, keys, ctx):
        self.stage_inputs = stage_inputs
        self.body = body
        #: the metrics the body emits, in the order the program stacks them
        self.keys = keys
        self.ctx = ctx

    def __call__(self, state: FedMeshState, batch, seed):
        inputs = self.stage_inputs(state, [seed])
        return self.body(state, batch, _map(lambda t: t[0], inputs))


def build_fed_round(model, fed: FedConfig, train: TrainConfig, ctx, *,
                    chunk: int = 2048,
                    kernel_impl: Optional[object] = None) -> MeshRound:
    """Returns this rank's round, ``fed_round(state, batch, seed) ->
    (state, metrics)`` (a :class:`MeshRound`). ``batch``: this rank's
    shard of the round's batch (:func:`shard_batch`), tensors with a
    leading K dim on the state's device; ``seed``: the round's shared
    seed, the same on every rank. ``kernel_impl``: a
    ``kernels.ops.KernelImpl`` (the selection and the fused ingest through
    their kernels; the dense-hat EF and the two-pass server step launch
    theirs on CUDA tensors without one)."""
    if getattr(model, "tp", 1) != max(ctx.tp, 1):
        raise ValueError(f"the model is built for tp={model.tp} but the "
                         f"context's model axis has tp={ctx.tp}")
    # On the mesh "topk" means the blockwise kernel semantics (global top-k
    # of a sharded leaf is ill-defined); exact global top-k is FedSim's.
    comp_name = "blocktopk" if fed.compressor == "topk" else fed.compressor
    if fed.ef_store:
        raise ValueError(
            "FedConfig.ef_store is FedSim-only — the mesh backend already "
            "shards per-client EF state over the client axes (one row per "
            "client-axis device); there is no resident (m, d) buffer to "
            "stream")
    strategy = mesh_agg_strategy(fed)
    fcfg = fed.fault
    if fed.deadline_s > 0 or (fcfg is not None and fcfg.deadline_s > 0):
        raise ValueError(
            "deadline_s is FedSim wire-mode only — the mesh backend has "
            "no transport clock to cut against; model stragglers as "
            "crashes (FaultConfig.crash_prob / crash_trace) on the mesh")
    validating = fcfg is not None and (fcfg.corrupt_prob > 0
                                       or fcfg.max_update_norm > 0)
    if validating and strategy != "sparse_topk":
        raise ValueError(
            f"FaultConfig corruption/validation on the mesh needs the "
            f"flat compacted-Selection collective (strategy "
            f"'sparse_topk'), but this config resolves {strategy!r} — "
            f"the validation-before-ingest gate inspects gathered "
            f"(vals, idx) payloads, which the dense psum / hierarchical "
            f"partials never materialize per client")
    if fed.agg_groups > 1 and strategy != "sparse_topk_hier":
        raise ValueError(
            f"FedConfig.agg_groups={fed.agg_groups} but this config "
            f"resolves the {strategy!r} aggregation strategy — the two-"
            f"level collective only exists for the compacted-Selection "
            f"path (fedcams + aggregation='sparse' + topk/blocktopk)")
    if strategy == "sparse_topk_hier":
        # the FIRST client axis is the group axis
        if len(fed.client_axes) < 2:
            raise ValueError(
                f"agg_groups={fed.agg_groups} needs >= 2 client axes — "
                f"the first enumerates the groups, the rest the members "
                f"(e.g. client_axes=('cgroup', 'data')); got "
                f"{fed.client_axes!r}")
        if fed.num_clients % fed.agg_groups:
            raise ValueError(
                f"agg_groups={fed.agg_groups} must divide the client-axis "
                f"size m={fed.num_clients} (the mesh reshapes the client "
                f"axis into (groups, members))")
    sharded = fed.shard_server_state and fed.state_shards > 1
    if sharded and fed.state_shards != ctx.axis_size(state_shard_axes(fed)):
        raise ValueError(
            f"FedConfig.state_shards={fed.state_shards} must equal the "
            f"ranks along the state-shard axes {state_shard_axes(fed)} "
            f"({ctx.axis_size(state_shard_axes(fed))})")
    fused = resolve_fused_ingest(
        fed,
        eligible=(strategy == "sparse_topk" and not sharded
                  and fcfg is None),
        have_kernel=kernel_impl is not None,
        compiled=kernel_impl is not None and kernel_impl.compiled,
        detail="the mesh fuses only the sparse_topk aggregation strategy "
               "(fedcams + aggregation='sparse' + topk/blocktopk) without "
               "shard_server_state or fault injection (the masked "
               "survivor aggregate needs the unfused gather path)"
               + FUSED_INGEST_GROUPS_DETAIL)
    # one block layout for the whole sparse path: the kernels', when they
    # select or ingest, so the wire metric and the selections agree
    sparse_block = 2048
    if strategy in ("sparse_topk", "sparse_topk_hier"):
        if (resolve_mesh_sparse_impl(fed, kernel_impl) == "kernel"
                or fused == "kernel"):
            sparse_block = kernel_impl.block
    comp = (make_compressor(comp_name, fed.compress_ratio, sparse_block)
            if fed.algorithm == "fedcams" else None)
    randk = comp is not None and comp.name.startswith("randk")
    rule = make_local_update(fed)
    m_clients = fed.num_clients
    n_part = fed.participating or m_clients
    hierarchical = "data" not in fed.client_axes  # within-client DP on "data"
    defs = model.defs()
    # measured uplink bytes (a host constant, as JAX's trace-time one): all
    # m clients feed the tier-1 collective (non-participants send masked
    # zeros), the root tier one dense partial per GROUP — billed on this
    # rank's leaves (its model shards), as init_fed_state shapes them
    sizes = _mesh_sizes(ctx)
    tiers = mesh_wire_bytes_tiers(
        fed, tree_map(lambda d: torch.empty(pdefs.local_shape(d, sizes),
                                            device="meta"), defs),
        block=sparse_block, tp=ctx.tp)
    wire_bytes = float(m_clients * tiers["tier1"]
                       + fed.agg_groups * tiers["tier2"])
    keys = tuple(mesh_metric_specs(fed))

    def stage_inputs(state: FedMeshState, seeds) -> MeshRoundInputs:
        """R rounds' host draws (``seeds``: the rounds' shared seeds), each
        from the generator and in the order the round has always drawn it:
        η_l of rounds ``int(state.round)`` + r (the state's one host read
        a call); this rank's step count (``round_generator(seed, 0)``); the
        participation mask (``round_generator(seed, 1)``) times the crash
        mask of ``mesh_fault_mask``; this rank's row of
        ``mesh_corruption_plan``; randk's positions
        (``round_generator(seed, 2)``, leaf by leaf). Stacked on the
        state's device."""
        round0 = int(state.round)
        dev = tree_leaves(state.params)[0].device
        ci = ctx.client_index()
        eta, ks, masks, plans, draws = [], [], [], [], []
        for r, seed in enumerate(seeds):
            seed = int(seed)
            eta.append(local_lr(fed, round0 + r))
            k_all = hetero_step_counts(fed, round_generator(seed, 0),
                                       m_clients)
            ks.append(None if k_all is None else k_all[ci])
            mask = participation_mask(round_generator(seed, 1), m_clients,
                                      n_part)
            if fcfg is not None:
                # crashed clients drop out of the round like
                # non-participants: zero contribution, stale EF row
                mask = mask * mesh_fault_mask(fcfg, seed, m_clients,
                                              round0 + r)
            masks.append(mask)
            if validating:
                plan = mesh_corruption_plan(fcfg, seed, m_clients)
                plans.append(FaultPlan(*(a[ci:ci + 1] for a in plan)))
            if randk:
                draws.append(randk_leaf_positions(
                    comp, state.params, round_generator(seed, 2)))
        with stage("host_to_device", "mesh"):
            return MeshRoundInputs(
                eta_l=torch.tensor(eta, dtype=torch.float32).to(dev),
                k_i=None if ks[0] is None else torch.stack(ks).to(dev),
                mask=torch.stack(masks).to(dev),
                plan=(FaultPlan(*(torch.stack(f).to(dev)
                                  for f in zip(*plans)))
                      if plans else None),
                randk=(tree_map(lambda *t: torch.stack(t), *draws)
                       if draws else None))

    def body(state: FedMeshState, batch, inp: MeshRoundInputs):
        """One round from ``state`` on ``batch`` with its slot of the
        staged inputs (0-d and (m,) tensors on the device). Reads nothing
        on the host."""
        params = state.params
        flat0, unravel = pdefs.ravel(params)
        flat0 = flat0.float()
        dev = flat0.device

        def grad_fn(p, b):
            p = p.detach().requires_grad_(True)
            loss, _ = model.loss(unravel(p), b, ctx,
                                 remat_policy=train.remat_policy, chunk=chunk)
            (g,) = torch.autograd.grad(loss, p)
            if hierarchical and ctx.data_axis:
                g = ctx.psum_data(g) / torch.full((), ctx.dp,
                                                  dtype=g.dtype, device=dev)
            return loss.detach(), g

        ci = ctx.client_index()
        with stage("local_training", "mesh"):
            local, loss_local = run_local_steps(rule, grad_fn, flat0, batch,
                                                inp.eta_l, k_i=inp.k_i)
            delta = unravel((local - flat0).float())
            # neither is read again: free their 2·d floats before the
            # uplink and the server step allocate theirs
            del local, flat0
            sync_model_replicas(delta, defs, ctx)

        # participation: the same mask on every rank (shared draw)
        mask = inp.mask
        n_eff = (mask.sum().clamp_min(1.0) if fcfg is not None
                 else float(n_part))
        my_mask = mask[ci]

        my_err = tree_map(lambda e: e[0], state.errors)
        st = ServerState(m=state.m, v=state.v, vhat=state.vhat,
                         t=state.round)

        def _server_step(agg):
            with stage("server_update", "mesh"):
                if sharded:
                    return _sharded_server_update(fed, st, params, agg,
                                                  model, ctx)
                return server_update_tree(fed, st, params, agg)

        def select():
            with stage("uplink", "mesh"):
                return mesh_select_tree(fed, comp, kernel_impl, delta,
                                        my_err, my_mask)

        rejected = torch.zeros((), dtype=torch.float32, device=dev)
        if fused != "off":
            # one-pass fused ingest: select once, all_gather the compacted
            # Selections (the same collective and payload as
            # sparse_topk_leaf), scatter-mean + FedAMS step in one pass
            sels, new_err = select()
            gather = lambda a: ctx.all_gather_clients(a[None], axis=0)
            with stage("server_ingest", "mesh"):
                if fused == "kernel":
                    new_params, new_st = kernel_impl.fedams_ingest_tree(
                        fed, st, params, sels, n_eff, gather)
                else:
                    new_params, new_st = server_ingest_tree(
                        fed, st, params, sels, n_eff, gather,
                        block=sparse_block, impl="jnp")
        elif validating:
            # damage this rank's OWN payload in transit (every rank holds
            # the same plan, so every gathered copy shows the damage),
            # validate server-side, aggregate over alive ∧ valid; a
            # rejected client's EF row rolls back to its pre-round value
            sels, new_err = select()

            def leaf_fault(s, lf):
                cv, cidx = corrupt_selection(s.vals[None], s.idx[None],
                                             inp.plan, fcfg.corrupt_mode)
                bs, nb = block_layout(lf.numel(), sparse_block)
                return sparse_topk_leaf_validated(
                    Selection(vals=cv[0], idx=cidx[0]), lf, mask, ctx,
                    bs * nb, fcfg.max_update_norm)

            with stage("validate", "mesh"):
                outs = tree_map(leaf_fault, sels, delta)
            agg = tree_unzip(outs, 3)[0]
            triples = tree_leaves(outs)
            rejected = triples[0][2]
            # a client survives only if EVERY leaf validated
            my_valid = triples[0][1]
            for t in triples[1:]:
                my_valid = my_valid * t[1]
            new_err = tree_map(
                lambda ne, eo: torch.where(my_valid > 0, ne, eo),
                new_err, my_err)
            new_params, new_st = _server_step(agg)
        else:
            with stage("uplink", "mesh"):
                agg, new_err = mesh_uplink(fed, comp, ctx, kernel_impl,
                                           inp.randk, delta, my_err,
                                           my_mask, n_eff)
            new_params, new_st = _server_step(agg)

        errors = tree_map(lambda ne: ne.unsqueeze(0), new_err)
        # the clients' losses in client order, averaged as FedSim averages
        # its cohort's
        loss = ctx.all_gather_clients(loss_local.reshape(1), axis=0).mean()
        if hierarchical:
            loss = ctx.pmean_data(loss)
        if ctx.model_axis:
            # the model ranks' losses are one loss computed tp times (its
            # replicated part by each rank itself): their mean, the same on
            # every rank, as the reference's is model-invariant
            loss = ctx.psum_axes((ctx.model_axis,), loss) / ctx.tp
        new_state = FedMeshState(params=new_params, m=new_st.m, v=new_st.v,
                                 vhat=new_st.vhat, errors=errors,
                                 round=new_st.t)
        met = {"loss": loss,
               "wire_up_bytes": torch.full((), wire_bytes,
                                           dtype=torch.float32, device=dev)}
        if fcfg is not None:
            met["survivors"] = mask.sum()
            met["rejected"] = rejected
        return new_state, met

    return MeshRound(stage_inputs, body, keys, ctx)


def mesh_metric_specs(fed: FedConfig, *, scan: bool = False):
    """The metrics ``build_fed_round`` emits, each with its layout: ``()``
    a replicated scalar, ``(None,)`` the (R,) stack of
    :func:`build_fed_rounds_scan` (``scan=True``) — the keys launch sites
    read, so the fault-metric keys cannot drift from the round body."""
    sp = (None,) if scan else ()
    specs = {"loss": sp, "wire_up_bytes": sp}
    if fed.fault is not None:
        specs["survivors"] = sp
        specs["rejected"] = sp
    return specs


def captures_rounds(device, ctx) -> bool:
    """Whether :func:`build_fed_rounds_scan` captures a round into a CUDA
    graph on this rank: on a CUDA state whose collectives run over NCCL (or
    that runs none: no mesh). gloo's collectives run on the host and cannot
    be captured, so on gloo, as on the CPU, the staged body runs eagerly.
    Decided from the device and the backend before anything runs."""
    if torch.device(device).type != "cuda":
        return False
    if ctx.mesh is None or not dist.is_initialized():
        return True
    return dist.get_backend() == "nccl"


def _map(fn, tree):
    """``fn`` over the tensors of a tree of named tuples, tuples, dicts
    and Nones (kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_map(fn, v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _tensors(tree) -> list:
    """The tensors of such a tree, a dict's by sorted key (so two trees
    built in another key order pair leaf by leaf)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return []


def _structure(tree):
    """The shape of such a tree without its tensors' shapes."""
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_structure(v) for v in tree)
    return type(tree).__name__


class _RoundsProgram:
    """R mesh rounds as one program: the carry (the state's own tensors,
    adopted on the first call: no second copy of the state), static inputs
    of ``capacity`` rounds (the staged batches and :class:`MeshRoundInputs`),
    a round counter on the device that the body reads its slot at, and
    (keys, capacity) metric slots. With ``captured`` one round is captured
    into a CUDA graph on a stream of its own, after a warm-up round on that
    stream whose result is dropped (it makes the lazy state — the NCCL
    communicator, cuBLAS handles, the autograd engine's device thread —
    before capture), and each run replays it; else the body runs eagerly.
    ``counts``: the kernel launches the capture recorded into the graph
    (:func:`repro_torch.kernels.ops.captured_launches`)."""

    def __init__(self, rnd: MeshRound, state: FedMeshState, batches,
                 inputs: MeshRoundInputs, captured: bool):
        self.rnd = rnd
        self.captured = captured
        dev = tree_leaves(state.params)[0].device
        self.capacity = len(inputs.eta_l)
        self.carry = state
        self.inputs = _map(torch.empty_like, (batches, inputs))
        self.ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        self.out = torch.zeros((len(rnd.keys), self.capacity),
                               dtype=torch.float32, device=dev)
        self.graph = self.counts = None
        self.stream = torch.cuda.Stream(dev) if captured else None

    def load(self, state: FedMeshState, batches, inputs) -> None:
        """The state into the carry (unless it is the carry), the R rounds'
        inputs into the first R slots, the counter to 0."""
        for dst, src in zip(_tensors(self.carry), _tensors(state)):
            if dst is not src:
                dst.copy_(src)
        for dst, src in zip(_tensors(self.inputs),
                            _tensors((batches, inputs))):
            dst[:src.shape[0]].copy_(src)
        self.ctr.zero_()

    def step(self, write: bool = True) -> None:
        """One round of the body on the carry at round ``ctr``'s inputs;
        with ``write`` its new state copied into the carry (a leaf the
        round left as it was is its slot already), its metrics into column
        ``ctr``, the counter + 1."""
        at = lambda t: t.index_select(0, self.ctr)[0]
        batches, inputs = _map(at, self.inputs)
        with ops.rows_prechecked():
            new, met = self.rnd.body(self.carry, batches, inputs)
        if not write:
            return
        for dst, src in zip(_tensors(self.carry), _tensors(new)):
            if src is not dst:
                dst.copy_(src)
        for j, key in enumerate(self.rnd.keys):
            self.out[j].index_copy_(0, self.ctr,
                                    met[key].reshape(1).to(self.out.dtype))
        self.ctr.add_(1)

    def run(self, R: int):
        """R rounds from the loaded carry → the (keys, R) metrics on the
        host (the one host read; a copy of the slots, which the next call
        writes again) and, on CUDA, each round's ms by CUDA events (a
        replay's, or an eager body's)."""
        dev = self.out.device
        timed = dev.type == "cuda"
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(R + 1)] if timed else []
        read = lambda: self.out[:, :R].to("cpu", copy=True)
        if not self.captured:
            for r in range(R):
                if timed:
                    events[r].record()
                self.step()
            if timed:
                events[R].record()
            return read(), events
        here = torch.cuda.current_stream(dev)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            if self.graph is None:
                self.step(write=False)
                # the warm-up's freed blocks back to the card: the
                # capture's pool is its own and cannot reuse them
                torch.cuda.empty_cache()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                # thread-local: another thread's CUDA calls (the NCCL
                # watchdog's event queries) do not void this capture
                with ops.captured_launches() as counts:
                    with torch.cuda.graph(graph, stream=self.stream,
                                          capture_error_mode="thread_local"):
                        self.step()
                graph.instantiate()
                self.graph, self.counts = graph, counts
            for r in range(R):
                events[r].record()
                self.graph.replay()
            events[R].record()
        here.wait_stream(self.stream)
        return read(), events


class MeshRounds:
    """``rounds_fn(state, batches, seeds) -> (state, stacked metrics)``:
    :func:`build_fed_rounds_scan`'s multi-round program; :meth:`round` is
    the per-round step through the same program at R = 1. ``last`` holds
    what the latest call did: ``captured`` (one CUDA graph of a round
    replayed, or the staged body run eagerly), ``built`` (whether the call
    made its program: a capture, on CUDA + NCCL), ``rounds``, ``events``
    (each round's CUDA events, read by :meth:`round_ms`; None on the CPU)
    and ``program``."""

    def __init__(self, rnd: MeshRound, log=None):
        self.rnd = rnd
        self.log = log
        self.programs = {}
        self.last = None
        register_programs(self)

    def clear_programs(self) -> None:
        """Drops every program kept (graphs, pools and static inputs; a
        carry is the caller's state): ``repro_torch.clear_caches``. The
        next call builds its program again."""
        self.programs.clear()
        self.last = None

    def _program(self, state, batches, inputs):
        dev = tree_leaves(state.params)[0].device
        shapes = lambda tree: tuple((tuple(t.shape), t.dtype)
                                    for t in _tensors(tree))
        rows = lambda tree: tuple((tuple(t.shape[1:]), t.dtype)
                                  for t in _tensors(tree))
        key = (str(dev), shapes(state), rows((batches, inputs)),
               _structure((batches, inputs)),
               torch.are_deterministic_algorithms_enabled(),
               torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        R = len(inputs.eta_l)
        prog = self.programs.get(key)
        built = prog is None or prog.capacity < R
        if built:
            captured = captures_rounds(dev, self.rnd.ctx)
            prog = self.programs[key] = _RoundsProgram(
                self.rnd, state, batches, inputs, captured)
            if self.log:
                backend = (dist.get_backend() if dist.is_initialized()
                           else "no process group")
                self.log(
                    f"staged mesh rounds on {dev} ({backend}): "
                    + ("one round captured into a CUDA graph, replayed "
                       "once a round" if captured
                       else "the staged body run eagerly, round by round"))
        return prog, built

    def __call__(self, state: FedMeshState, batches, seeds):
        """R = len(seeds) rounds on ``batches`` (this rank's (R, K, ...)
        shard, :func:`shard_batch` with ``staged``) from ``state``, which
        the call consumes: the state returned is the program's carry, the
        input state's own tensors on the first call (any other state is
        copied into the carry). Returns it and the metrics, each a (R,)
        tensor on the host. Inside :func:`repro_torch.disable_graphs` the R
        rounds run one after another as the round itself, building no
        program (``last`` then says so)."""
        if not graphs_enabled():
            return self._eager(state, batches, seeds)
        inputs = self.rnd.stage_inputs(state, seeds)
        prog, built = self._program(state, batches, inputs)
        prog.load(state, batches, inputs)
        R = len(seeds)
        stacked, events = prog.run(R)
        self.last = dict(captured=prog.captured, built=built, rounds=R,
                         events=events, program=prog)
        return prog.carry, {k: stacked[j] for j, k in
                            enumerate(self.rnd.keys)}

    def _eager(self, state: FedMeshState, batches, seeds):
        """:meth:`__call__` inside :func:`repro_torch.disable_graphs`: R =
        len(seeds) eager rounds, ``fed_round(state, batch, seed)``, on
        round r's slot of ``batches``; the metrics stacked on the host as
        the program's slots hold them."""
        cols = []
        for r, seed in enumerate(seeds):
            state, met = self.rnd(state, _map(lambda t: t[r], batches), seed)
            cols.append(torch.stack([met[k].reshape(()).to(torch.float32)
                                     for k in self.rnd.keys]))
        self.last = dict(captured=False, built=False, rounds=len(seeds),
                         events=None, program=None)
        stacked = torch.stack(cols, 1).cpu()
        return state, {k: stacked[j] for j, k in enumerate(self.rnd.keys)}

    def round(self, state: FedMeshState, batch, seed):
        """One round, ``fed_round(state, batch, seed)``, as the reference's
        jitted step: through this object's program at R = 1 (``batch``:
        this rank's shard of one round, :func:`shard_batch` without
        ``staged``), the one program kept across the calls, on CUDA + NCCL
        one captured round replayed once a call. The state is consumed and
        the carry returned, as :meth:`__call__` does; the metrics are 0-d
        tensors on the host. Inside :func:`repro_torch.disable_graphs` the
        round itself runs (``last`` then says so)."""
        if not graphs_enabled():
            self.last = dict(captured=False, built=False, rounds=1,
                             events=None, program=None)
            return self.rnd(state, batch, seed)
        state, stacked = self(state, _map(lambda t: t.unsqueeze(0), batch),
                              [seed])
        return state, {k: v[0] for k, v in stacked.items()}

    def round_ms(self):
        """The latest call's rounds' ms by CUDA events (after the call's
        read, so reading them waits for nothing); None on the CPU."""
        ev = (self.last or {}).get("events")
        if not ev:
            return None
        return [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]


def build_fed_rounds_scan(fed_round: MeshRound, log=None) -> MeshRounds:
    """Lift this rank's round to the multi-round program ``(state,
    batches[R], seeds[R]) -> (state, stacked metrics)``, the reference's
    ``lax.scan`` over rounds: R rounds as one program, with no host work
    between the first round and the one host read of the (keys, R)
    metrics at the end. The host draws of all R rounds are staged first
    (:meth:`MeshRound.stage_inputs`, the prelude the eager round runs at R
    = 1); then the round body runs round after round on the state's own
    tensors (donated, as the reference's jit donates its carry: the input
    state is consumed), reading its round's inputs at a round counter on
    the device. On a CUDA state whose process group is NCCL
    (:func:`captures_rounds`) one round is captured into a
    ``torch.cuda.CUDAGraph`` after a warm-up round and replayed R times;
    on gloo or the CPU the same body runs eagerly. The choice is made up
    front, reported in ``last["captured"]`` and logged (``log``) when a
    program is made; a capture or launch that fails raises. A program is
    kept per shape and setting (deterministic algorithms, TF32) and reused
    by later calls of as many rounds or fewer (chunks of 3, then 1, and
    :meth:`MeshRounds.round`'s one round a call: the reference's jitted
    per-round step)."""
    return MeshRounds(fed_round, log)


def stage_mesh_rounds(lm_data, r0: int, count: int, local_steps: int,
                      global_batch: int, seq_len: int):
    """Host-side staging for ``count`` mesh rounds: the stacked (R, ...)
    GLOBAL batch dict (numpy) + (R,) int32 seeds for
    :func:`build_fed_rounds_scan` (cut to this rank with
    :func:`shard_batch`)."""
    raws = [lm_data.mesh_batch(r, local_steps, global_batch, seq_len)
            for r in range(r0, r0 + count)]
    batch = {k: np.stack([b[k] for b in raws]) for k in raws[0]}
    return batch, torch.arange(r0, r0 + count, dtype=torch.int32)


def fed_batch_defs(model, fed: FedConfig, train: TrainConfig):
    """GLOBAL batch defs with client-axis sharding, leading K dim."""
    b = model.train_batch_defs(train.global_batch, train.seq_len)
    ax = _axes_spec(client_batch_axes(fed))

    def stack_k(d: pdefs.ParamDef):
        spec = list(d.dim_specs)
        spec[0] = ax  # batch dim over client (+data) axes
        return dataclasses.replace(
            d, shape=(fed.local_steps,) + tuple(d.shape),
            spec=(None,) + tuple(spec))

    return tree_map(stack_k, b)


def shard_batch(batch, model, fed: FedConfig, train: TrainConfig, ctx,
                device=None, *, staged: bool = False):
    """A round's GLOBAL batch (arrays or tensors, leading K; with
    ``staged`` the (R, K, ...) stack of :func:`stage_mesh_rounds`) → this
    rank's shard on ``device``, cut along the batch dim as
    :func:`fed_batch_defs` shards it (client-major over the client, then
    data, axes). ``device`` None means CUDA, as in :func:`init_fed_state`."""
    device = resolve_device(device)
    defs = fed_batch_defs(model, fed, train)

    def cut(a, d):
        t = torch.as_tensor(np.asarray(a))
        if staged:
            d = dataclasses.replace(d, shape=(t.shape[0],) + d.shape,
                                    spec=(None,) + d.dim_specs)
        return pdefs.take_shard(t, d, ctx).to(device=device).contiguous()

    return tree_map(cut, batch, defs)
