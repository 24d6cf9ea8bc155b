"""Builders that bind (architecture × input shape × mesh) to one rank's
step function plus its abstract inputs.

Counterpart of ``repro.launch.steps``. The reference jit-wraps a
``shard_map`` and hands ``.lower()`` ``ShapeDtypeStruct``s with
``NamedSharding``s. Here a step is a plain function of tensors that one
rank runs (every rank of a mesh runs the same local shapes, so rank 0's
program stands for the SPMD per-device program), and ``abstract_args`` are
``meta`` tensors of this rank's LOCAL shapes (``models.params.
local_shape``): no allocation, no data. ``launch/dryrun.py`` runs
``fn(*abstract_args)`` under ``launch/op_analysis.OpCost``; on a card the
same ``fn`` runs on real tensors of those shapes.

Two inputs are real values, not meta tensors: the train round's seed and
round counter (CPU int32 scalars: the round draws its participation from
them on the host, ``core.mesh``), and the decode position (an int, or a
0-d int tensor, which the step reads on the device: the cache slot and,
sequence-sharded, the rank that writes it). The reference traces both.

Every step's ``fn`` is the reference's jit. The train step's is a
``launch.programs.TrainStep``: the mesh's per-round program, one captured
round replayed a call where the round's collectives can be captured (CUDA
with NCCL or none), its staged body run eagerly on the CPU and on gloo,
and the eager round on ``meta``. It
consumes the state it is given (the reference's step does not donate:
ROADMAP Queue 3 item 40). The serving steps' is a
``launch.programs.PrefillStep`` / ``DecodeStep``, a captured program
(one CUDA graph per shape, replayed a call) where the step's collectives
can be captured, and the eager step elsewhere: on ``meta`` (the dry run,
``op_analysis``), on the CPU and on gloo. So the dry run and
``op_analysis`` trace and reckon what they always did.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``); the ``ParallelContext`` a ``build_*`` makes
over it is collective when it names several dims at once (client axes
``("pod", "data")``), so every rank builds the same bundles in the same
order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (FedConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs.registry import ArchSpec
from repro_torch.core.mesh import (FedMeshState, build_fed_round,
                                   fed_batch_defs, fed_state_defs)
from repro_torch.launch.programs import DecodeStep, PrefillStep, TrainStep
from repro_torch.models import params as pdefs
from repro_torch.models.model import Model
from repro_torch.sharding.rules import ParallelContext

# ---------------------------------------------------------------------------
# Resolution helpers
# ---------------------------------------------------------------------------


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_fed(spec: ArchSpec, fed: FedConfig, mesh) -> FedConfig:
    """Bind client axes + client count to the mesh per the arch's FL mode."""
    sizes = mesh_axis_sizes(mesh)
    if spec.client_mode == "per_pod":
        axes = tuple(a for a in ("pod",) if a in sizes)
    else:
        axes = tuple(a for a in ("pod", "data") if a in sizes)
    m = 1
    for a in axes:
        m *= sizes[a]
    shard_axes = axes if axes else tuple(a for a in ("data",) if a in sizes)
    shards = 1
    for a in shard_axes:
        shards *= sizes[a]
    return dataclasses.replace(fed, client_axes=axes, num_clients=m,
                               state_shards=shards)


def train_ctx(fed: FedConfig, mesh,
              tp_collective: str = "psum") -> ParallelContext:
    sizes = mesh_axis_sizes(mesh)
    hierarchical = "data" not in fed.client_axes
    return ParallelContext(
        model_axis="model", tp=sizes.get("model", 1),
        data_axis="data" if hierarchical else None,
        dp=sizes.get("data", 1) if hierarchical else 1,
        client_axes=fed.client_axes, num_clients=fed.num_clients,
        tp_collective=tp_collective, mesh=mesh)


def serve_ctx(mesh, *, seq_sharded: bool) -> ParallelContext:
    """The serving context; ``seq_sharded`` puts the sequence axis on
    ``"data"`` (its size, the reference's ``seq_shards``, is read off the
    mesh: ``ParallelContext.seq_shards``)."""
    sizes = mesh_axis_sizes(mesh)
    return ParallelContext(
        model_axis="model", tp=sizes.get("model", 1),
        seq_axis="data" if seq_sharded else None, mesh=mesh)


def serve_batch_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def remap_defs(defs, mapping: Dict[str, Any]):
    """Rewrite mesh-axis names inside ParamDef specs (e.g. "data" ->
    ("pod","data") when a batch dim spreads over two axes)."""

    def one(d: pdefs.ParamDef) -> pdefs.ParamDef:
        spec = tuple(mapping.get(e, e) if isinstance(e, str) else e
                     for e in (d.spec or ()))
        return dataclasses.replace(d, spec=spec)

    return pdefs.tree_map(one, defs)


def variant_for_shape(spec: ArchSpec, shape: ShapeConfig) -> ModelConfig:
    """Apply the (flagged) sliding-window long-context variant if needed."""
    cfg = spec.model
    if shape.name == "long_500k" and spec.long_500k == "variant":
        w = cfg.long_context_variant_window or 4096
        cfg = dataclasses.replace(cfg, attn_pattern=(w,))
    return cfg


def shape_allowed(spec: ArchSpec, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.kind == "decode" and not spec.has_decode:
        return False, "encoder-only architecture: no decode step"
    if shape.name == "long_500k" and spec.long_500k == "skip":
        return False, "pure full-attention / encoder arch: long_500k skipped"
    return True, ""


# ---------------------------------------------------------------------------
# Step bundles
# ---------------------------------------------------------------------------


@dataclass
class StepBundle:
    """One rank's step plus abstract inputs of its local shapes:
    ``fn(*abstract_args)`` on ``meta`` (``launch/op_analysis.OpCost``), or
    ``fn`` on real tensors of the same shapes on the card. ``ctx`` is the
    context the step runs under."""

    fn: Callable
    abstract_args: Tuple
    model: Model
    fed: Optional[FedConfig] = None
    description: str = ""
    ctx: Optional[ParallelContext] = None


def _abstract(defs, sizes: Dict[str, int]):
    """``meta`` tensors of each leaf's local shape and dtype."""
    return pdefs.tree_map(
        lambda d: torch.empty(pdefs.local_shape(d, sizes),
                              dtype=getattr(torch, d.dtype), device="meta"),
        defs)


def build_train_step(spec: ArchSpec, shape: ShapeConfig, mesh,
                     fed: FedConfig, train: TrainConfig,
                     *, kernel_impl=None, chunk: int = 2048) -> StepBundle:
    """The paper's fed_round as the train step for this (arch, mesh):
    ``fn(state, batch, seed) -> (state, metrics)``, a
    ``launch.programs.TrainStep`` of ``core.mesh.build_fed_round``'s round
    (its local phase runs forward and backward; ``fn.eager`` is the round
    itself)."""
    assert shape.kind == "train"
    cfg = spec.model
    sizes = mesh_axis_sizes(mesh)
    fed = resolve_fed(spec, fed, mesh)
    train = dataclasses.replace(train, global_batch=shape.global_batch,
                                seq_len=shape.seq_len)
    model = Model(cfg, tp=sizes.get("model", 1))
    ctx = train_ctx(fed, mesh, train.tp_collective)

    sdefs = fed_state_defs(model, fed)
    bdefs = fed_batch_defs(model, fed, train)
    fn = TrainStep(build_fed_round(model, fed, train, ctx, chunk=chunk,
                                   kernel_impl=kernel_impl))
    state = FedMeshState(*(_abstract(t, sizes) for t in sdefs[:-1]),
                         round=torch.zeros((), dtype=torch.int32))
    abstract = (state, _abstract(bdefs, sizes),
                torch.zeros((), dtype=torch.int32))
    return StepBundle(fn=fn, abstract_args=abstract, model=model, fed=fed,
                      description=f"fed_round[{fed.algorithm}/"
                                  f"{fed.compressor}:{fed.aggregation}] "
                                  f"K={fed.local_steps} m={fed.num_clients}",
                      ctx=ctx)


def build_prefill_step(spec: ArchSpec, shape: ShapeConfig, mesh,
                       *, chunk: int = 2048) -> StepBundle:
    cfg = variant_for_shape(spec, shape)
    sizes = mesh_axis_sizes(mesh)
    model = Model(cfg, tp=sizes.get("model", 1))
    ctx = serve_ctx(mesh, seq_sharded=False)
    baxes = serve_batch_axes(mesh)
    bax = baxes[0] if len(baxes) == 1 else tuple(baxes)
    params = _abstract(model.defs(), sizes)

    if cfg.is_encoder:
        bdefs = {"embeddings": pdefs.ParamDef(
            (shape.global_batch, shape.seq_len, cfg.d_model),
            spec=(bax, None, None), dtype=cfg.dtype)}

        def step(params, batch):
            return model.encode(params, batch, ctx, chunk=chunk)

        return StepBundle(fn=step, abstract_args=(params,
                                                  _abstract(bdefs, sizes)),
                          model=model, description="encode (encoder-only "
                                                   "prefill)", ctx=ctx)

    tok_def = pdefs.ParamDef((shape.global_batch, shape.seq_len),
                             spec=(bax, None), dtype="int32")

    step = PrefillStep(model, ctx, max_len=shape.seq_len, chunk=chunk)
    return StepBundle(fn=step, abstract_args=(
        params, _abstract({"t": tok_def}, sizes)["t"]), model=model,
        description="prefill", ctx=ctx)


def build_decode_step(spec: ArchSpec, shape: ShapeConfig, mesh,
                      *, chunk: int = 2048) -> StepBundle:
    """``fn(params, token, caches, pos) -> (logits, caches)`` (a
    ``launch.programs.DecodeStep``: captured on CUDA + NCCL, where it
    consumes the caches given; the eager step elsewhere); the cache is
    sequence-sharded over ``"data"`` exactly at ``long_500k``."""
    cfg = variant_for_shape(spec, shape)
    sizes = mesh_axis_sizes(mesh)
    model = Model(cfg, tp=sizes.get("model", 1))
    seq_sharded = shape.name == "long_500k"
    ctx = serve_ctx(mesh, seq_sharded=seq_sharded)
    baxes = serve_batch_axes(mesh)
    bax = ((baxes[0] if len(baxes) == 1 else tuple(baxes))
           if not seq_sharded else None)

    cdefs = model.cache_defs(shape.global_batch, shape.seq_len,
                             seq_sharded=seq_sharded)
    if not seq_sharded and len(baxes) > 1:
        cdefs = remap_defs(cdefs, {"data": bax})
    tok_def = pdefs.ParamDef((shape.global_batch, 1), spec=(bax, None),
                             dtype="int32")

    step = DecodeStep(model, ctx, max_len=shape.seq_len)
    # the position: the cache's last slot (every slot filled)
    abstract = (_abstract(model.defs(), sizes),
                _abstract({"t": tok_def}, sizes)["t"],
                _abstract(cdefs, sizes), shape.seq_len - 1)
    return StepBundle(fn=step, abstract_args=abstract, model=model,
                      description="decode" + (" (seq-sharded cache)"
                                              if seq_sharded else ""),
                      ctx=ctx)


def build_step(spec: ArchSpec, shape: ShapeConfig, mesh, fed: FedConfig,
               train: TrainConfig, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(spec, shape, mesh, fed, train, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(spec, shape, mesh,
                                  chunk=kw.get("chunk", 2048))
    return build_decode_step(spec, shape, mesh, chunk=kw.get("chunk", 2048))
