"""Mesh/axis plumbing shared by model code and the federated runtime.

Counterpart of ``repro.sharding.rules``. The JAX package writes its round
in the manual-collective (``shard_map``) style: one program per device,
explicit collectives over named mesh axes. Here the program is one process
per rank (``torch.distributed``), the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with one named dim per JAX
mesh axis (:func:`repro_torch.launch.mesh.make_mesh`), and a
:class:`ParallelContext` runs each collective over the process group of
the named dims. When an axis is absent (``None``, or no mesh at all) every
helper is the identity, as in JAX, so the same code runs on one process in
tests.

Gathers come back in the JAX ``tiled`` layout, concatenated along the
gathered dim in client-major order: position ``i`` holds the rank whose
linear index over the gathered axes (first axis most significant) is
``i``. Every collective is a ``torch.distributed`` call on the tensor as
given (its device included); none copies to the host of its own accord.

``pad_to``, ``padded_vocab``, ``AttnDims`` and ``attn_dims`` are copies of
the originals (pure Python).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def pad_to(n: int, multiple: int) -> int:
    """Round ``n`` up to a multiple of ``multiple``."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def padded_vocab(vocab_size: int, tp: int) -> int:
    return pad_to(vocab_size, tp)


#: the ``torch.profiler`` range around every collective, so a profiled mesh
#: round reports the host time its collectives block for
#: (``scripts/profile_round.py m``)
COLLECTIVE_RANGE = "mesh.collective"


class _AxisGroup:
    """The process group over some named dims of a mesh, seen from one
    rank: ``ranks`` are the group's global ranks in client-major order
    (linear index over the dims in the order named, first most
    significant), ``index`` this rank's position in it."""

    def __init__(self, group, ranks: List[int]):
        self.group = group
        self.ranks = ranks
        self.index = ranks.index(dist.get_rank())
        # all_gather returns the group's ranks in its own order
        order = dist.get_process_group_ranks(group)
        self._pos = [order.index(r) for r in ranks]

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in self.ranks]
        with torch.profiler.record_function(COLLECTIVE_RANGE):
            dist.all_gather(parts, x, group=self.group)
        return [parts[p] for p in self._pos]


def _axis_groups(mesh, axes: Tuple[str, ...]) -> _AxisGroup:
    """Build the group over ``axes`` of ``mesh`` that holds this rank.
    A single dim reuses the mesh's own group; a tuple of dims makes one
    group per slice with ``dist.new_group``, which every rank of the world
    must call for every slice in the same order — so this is collective,
    called from :class:`ParallelContext` construction on every rank."""
    names = tuple(mesh.mesh_dim_names)
    for ax in axes:
        if ax not in names:
            raise ValueError(f"axis {ax!r} is not a dim of the mesh {names}")
    dims = [names.index(ax) for ax in axes]
    other = [i for i in range(len(names)) if i not in dims]
    size = 1
    for i in dims:
        size *= mesh.mesh.shape[i]
    rows = mesh.mesh.permute(other + dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    if len(axes) == 1:
        row = next(r for r in rows if me in r)
        return _AxisGroup(mesh.get_group(axes[0]), row)
    mine = None
    for row in rows:
        group = dist.new_group(row)
        if me in row:
            mine = _AxisGroup(group, row)
    return mine


class _PsumModel(torch.autograd.Function):
    """Megatron's [f] operator at a branch's exit: the all-reduce over the
    model axis forward, the identity backward (the transpose of JAX's
    psum of a model-varying value: its cotangent is model-invariant).
    ``rs_ag`` reduce-scatters dim 0 and all-gathers it back: on NCCL with
    ``reduce_scatter_tensor``; gloo has none, so there the reduction is the
    all-reduce and each rank keeps its slice before the gather — the
    psum's sums either way."""

    @staticmethod
    def forward(ctx, x, group, rs_ag):
        y = x.clone()
        n = len(group.ranks)
        with torch.profiler.record_function(COLLECTIVE_RANGE):
            if not rs_ag:
                dist.all_reduce(y, group=group.group)
                return y
            y = y.contiguous()
            chunk = y.shape[0] // n
            if dist.get_backend(group.group) == "nccl":
                part = y.new_empty((chunk,) + tuple(y.shape[1:]))
                dist.reduce_scatter_tensor(part, y, group=group.group)
            else:
                dist.all_reduce(y, group=group.group)
                part = y.narrow(0, group.index * chunk, chunk).contiguous()
        return torch.cat(group.all_gather(part), dim=0)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _TPCopy(torch.autograd.Function):
    """Megatron's [g] operator: identity forward, all-reduce of the
    gradient over the model axis backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group.group)
        return grad, None


@dataclass(frozen=True)
class ParallelContext:
    """Which mesh axes the current computation runs under, and the mesh.

    ``None`` axis names (or ``mesh=None``) mean "that form of parallelism
    is off" — all the collective helpers become identities, so model code
    is oblivious. Construct it on every rank alike: building the groups of
    several dims at once is collective (``dist.new_group``).
    """

    model_axis: Optional[str] = None
    tp: int = 1
    data_axis: Optional[str] = None
    dp: int = 1
    client_axes: Tuple[str, ...] = ()
    num_clients: int = 1
    seq_axis: Optional[str] = None   # sequence-sharded KV cache (long-context decode)
    # the model axis's all-reduce: "psum", or "rs_ag" (reduce-scatter then
    # all-gather, the reference's bf16-native TPU form: the same sums)
    tp_collective: str = "psum"      # "psum" | "rs_ag"
    mesh: Optional[object] = field(default=None, compare=False, repr=False)
    _groups: Dict = field(default_factory=dict, init=False, compare=False,
                          repr=False)

    def __post_init__(self):
        object.__setattr__(self, "client_axes", tuple(self.client_axes))
        if self.mesh is None:
            return
        wanted = [self.client_axes, self.client_axes[1:],
                  self.client_axes[:1]]
        wanted += [(ax,) for ax in (self.model_axis, self.data_axis,
                                    self.seq_axis) if ax]
        for axes in wanted:
            if axes and axes not in self._groups:
                self._groups[axes] = _axis_groups(self.mesh, axes)

    # -- generic collectives over a tuple of named dims ------------------
    def _group(self, axes) -> Optional[_AxisGroup]:
        axes = tuple(axes)
        if self.mesh is None or not axes:
            return None
        if axes not in self._groups:   # collective: all ranks get here
            self._groups[axes] = _axis_groups(self.mesh, axes)
        return self._groups[axes]

    def axis_size(self, axes) -> int:
        g = self._group(axes)
        return 1 if g is None else len(g.ranks)

    def axis_index(self, axes) -> int:
        """Linear index of this rank over ``axes`` (first most
        significant), as JAX's loop of ``axis_index``·``psum(1)``."""
        g = self._group(axes)
        return 0 if g is None else g.index

    def psum_axes(self, axes, x, op=dist.ReduceOp.SUM):
        g = self._group(axes)
        if g is None:
            return x
        y = x.clone()
        with torch.profiler.record_function(COLLECTIVE_RANGE):
            dist.all_reduce(y, op=op, group=g.group)
        return y

    def gather_axes(self, axes, x, axis: int = 0):
        """``all_gather(..., tiled=True)`` over ``axes``: the ranks' ``x``
        concatenated along ``axis`` in client-major order."""
        g = self._group(axes)
        if g is None:
            return x
        return torch.cat(g.all_gather(x), dim=axis)

    # -- collectives over the tensor-parallel axis ----------------------
    def tp_copy(self, x):
        """Branch-entry marker (Megatron's [g] operator): identity forward,
        all-reduce of the gradient over the model axis backward. Per-rank
        autograd has no varying-axes tracking to insert that psum, so the
        marker carries it."""
        g = self._group((self.model_axis,) if self.model_axis else ())
        return x if g is None else _TPCopy.apply(x, g)

    def psum_model(self, x):
        """The sum over the model axis; differentiable, its backward the
        identity (:class:`_PsumModel`). ``rs_ag`` takes it where dim 0
        splits evenly over the axis, as the reference does."""
        g = self._group((self.model_axis,) if self.model_axis else ())
        if g is None:
            return x
        n = len(g.ranks)
        rs_ag = (self.tp_collective == "rs_ag" and x.dim() >= 2
                 and x.shape[0] % n == 0 and x.shape[0] >= n)
        return _PsumModel.apply(x, g, rs_ag)

    def broadcast_model(self, x):
        """Model rank 0's ``x`` on every model rank (not
        differentiable)."""
        g = self._group((self.model_axis,) if self.model_axis else ())
        if g is None:
            return x
        y = x.contiguous().clone()
        with torch.profiler.record_function(COLLECTIVE_RANGE):
            dist.broadcast(y, src=g.ranks[0], group=g.group)
        return y

    def pmax_model(self, x):
        return self.psum_axes((self.model_axis,) if self.model_axis else (),
                              x, dist.ReduceOp.MAX)

    def all_gather_model(self, x, axis=-1):
        return self.gather_axes((self.model_axis,) if self.model_axis
                                else (), x, axis)

    def model_index(self):
        return self.axis_index((self.model_axis,) if self.model_axis else ())

    # -- collectives over the client axes (FL aggregation) --------------
    def psum_clients(self, x):
        return self.psum_axes(self.client_axes, x)

    def pmean_clients(self, x):
        x = self.psum_clients(x)
        return x / self.num_clients if self.client_axes else x

    def all_gather_clients(self, x, axis=0):
        """Gather over ALL client axes — every client ends up with the
        identical gathered tensor (the flat, single-tier aggregation)."""
        return self.gather_axes(self.client_axes, x, axis)

    # -- two-level hierarchical aggregation (DESIGN.md §scale-out) -------
    # Convention: the FIRST client axis is the group axis; the remaining
    # client axes enumerate each group's members.

    def all_gather_members(self, x, axis=0):
        """Tier 1: gather over the member axes only. Every member of a
        group sees the group's stacked payload; groups stay distinct."""
        if len(self.client_axes) < 2:
            raise ValueError(
                "all_gather_members needs >= 2 client axes — the first is "
                "the group axis (FedConfig.agg_groups hierarchical layout)")
        return self.gather_axes(self.client_axes[1:], x, axis)

    def all_gather_group_partials(self, x, axis=0):
        """Tier 2 (the root collective): gather the per-group partials over
        the group axis — g partials arrive, independent of the member
        count."""
        if len(self.client_axes) < 2:
            raise ValueError(
                "all_gather_group_partials needs >= 2 client axes — the "
                "first is the group axis")
        return self.gather_axes(self.client_axes[:1], x, axis)

    def client_index(self) -> int:
        """Linear index of this client across all client axes."""
        return self.axis_index(self.client_axes)

    # -- collectives over within-client data parallelism -----------------
    def psum_data(self, x):
        return self.psum_axes((self.data_axis,) if self.data_axis else (), x)

    def pmean_data(self, x):
        if not self.data_axis:
            return x
        return self.psum_data(x) / self.axis_size((self.data_axis,))

    # -- sequence-sharded decode -----------------------------------------
    def psum_seq(self, x):
        return self.psum_axes((self.seq_axis,) if self.seq_axis else (), x)

    def pmax_seq(self, x):
        return self.psum_axes((self.seq_axis,) if self.seq_axis else (), x,
                              dist.ReduceOp.MAX)

    @property
    def seq_shards(self) -> int:
        """The ranks a sequence-sharded cache is split over: the size of
        the sequence axis (the reference's field, here read off the
        mesh)."""
        return self.axis_size((self.seq_axis,) if self.seq_axis else ())

    def seq_index(self):
        return self.axis_index((self.seq_axis,) if self.seq_axis else ())

    def axis_sizes(self) -> Dict[str, int]:
        """Each mesh axis this context shards over (its model, data,
        sequence and client axes) → its size; a dim of the mesh it does not
        name is not among them (its ranks repeat the same work)."""
        names = [a for a in (self.model_axis, self.data_axis, self.seq_axis)
                 if a] + list(self.client_axes)
        return {a: self.axis_size((a,)) for a in names}

    def with_(self, **kw) -> "ParallelContext":
        """A copy with ``kw`` replaced that keeps this context's groups (no
        collective: the groups of an axis it lacks are built on first
        use)."""
        new = object.__new__(type(self))
        for f in fields(self):
            object.__setattr__(new, f.name, kw.get(f.name,
                                                   getattr(self, f.name)))
        object.__setattr__(new, "_groups", dict(self._groups))
        return new


@dataclass(frozen=True)
class AttnDims:
    """Resolved (padded) attention head layout for a given TP degree.

    ``q_heads``: padded global q-head count (multiple of tp).
    ``q_local``: q heads per model shard.
    ``kv_sharded``: whether kv heads are sharded over "model" (divisible) or
    replicated on every shard (small-kv GQA/MQA).
    ``kv_local``: kv heads materialized per shard.
    ``group``: q-heads per kv-head in the padded layout.
    """

    q_heads: int
    q_local: int
    kv_heads: int
    kv_sharded: bool
    kv_local: int
    group: int
    head_dim: int


def attn_dims(num_heads: int, num_kv_heads: int, head_dim: int, tp: int) -> AttnDims:
    q = pad_to(num_heads, tp)
    if num_kv_heads >= tp and num_kv_heads % tp == 0 and q % num_kv_heads == 0:
        kv = num_kv_heads
        kv_sharded = True
        kv_local = kv // tp
    else:
        # replicate kv heads; pad kv so q % kv == 0 in the padded layout
        kv = num_kv_heads
        while q % kv != 0:
            kv += 1
        kv_sharded = False
        kv_local = kv
    return AttnDims(
        q_heads=q,
        q_local=q // tp,
        kv_heads=kv,
        kv_sharded=kv_sharded,
        kv_local=kv_local,
        group=q // kv,
        head_dim=head_dim,
    )
