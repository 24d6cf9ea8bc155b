"""Parameter definitions, init, and the flat-vector layout.

Counterpart of ``repro.models.params``. A model exposes ``*_defs(cfg)`` — a
nested dict of :class:`ParamDef` — and params are nested dicts of tensors
in the same (JAX) shapes: HWIO convolution kernels, (in, out) matrices.

The federated round works on ONE flat fp32 vector per model. Blockwise
top-k cuts its blocks from that vector, so its order must equal
``jax.flatten_util.ravel_pytree``'s exactly: dict keys sorted at every
level, depth first, each leaf row-major in its JAX shape
(tests/test_torch_params.py). :func:`ravel` builds the vector and an
``unravel`` that returns views into it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    """``spec`` names, per dim, the mesh axes the dim is sharded over (an
    axis name, a tuple of names, or None) — JAX's ``PartitionSpec`` as a
    tuple. ``None`` for the whole spec means replicated on every dim."""
    shape: Tuple[int, ...]
    scale: float = 1.0
    dtype: str = "float32"
    init: str = "normal"      # normal | zeros | ones
    spec: Optional[Tuple] = None

    @property
    def dim_specs(self) -> Tuple:
        """``spec`` padded with None to one entry per dim."""
        spec = tuple(self.spec or ())
        return spec + (None,) * (len(self.shape) - len(spec))

    def stacked(self, n: int) -> "ParamDef":
        """Prepend a layer-stack (group) dimension, replicated."""
        return dataclasses.replace(self, shape=(n,) + tuple(self.shape),
                                   spec=(None,) + tuple(self.spec or ()))


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def stack_defs(defs, n: int):
    """Every def of ``defs`` with a leading group dim of ``n``."""
    return tree_map(lambda d: d.stacked(n), defs)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure (what
    ``jax.tree.map`` does on the port's param, def and state trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unzip(tree, n: int) -> Tuple:
    """A tree of n-tuple leaves → n trees of their parts."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def tree_leaves(tree) -> List:
    """The leaves of a nested dict in ``ravel_pytree`` order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    """``(path, leaf)`` pairs in ``ravel_pytree`` order: sorted dict keys,
    depth first."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def unflatten(paths: List[Tuple[str, ...]], leaves: List) -> Dict:
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def init_params(defs, generator: torch.Generator, device="cpu",
                ctx=None) -> Dict:
    """Concretely initialize a defs tree. Leaves are drawn in ravel order
    from ``generator`` on the generator's device and then moved to
    ``device``: a CPU ``torch.Generator`` gives the same init on every
    device; a CUDA one draws on the card (other numbers, no host copy of
    the weights). With ``ctx`` each leaf is drawn at its global shape and
    this rank keeps its shard (:func:`take_shard`), so every layout of the
    mesh holds the same numbers. The numbers differ from ``repro``'s (a JAX
    PRNG); parity runs convert the JAX init instead
    (``repro_torch.convert``)."""
    paths, leaves = [], []
    for path, d in leaves_with_paths(defs):
        dtype = getattr(torch, d.dtype)
        if d.init == "zeros":
            arr = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            arr = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            # in place: one copy of the leaf, not two (an expert stack of
            # deepseek-v3 is 15.0 GB)
            arr = torch.randn(d.shape, generator=generator, dtype=dtype,
                              device=generator.device).mul_(d.scale)
        if ctx is not None:
            arr = take_shard(arr, d, ctx)
        paths.append(path)
        leaves.append(arr.to(device, copy=ctx is not None).contiguous())
        del arr
    return unflatten(paths, leaves)


# -- global <-> per-rank shards ------------------------------------------------


def dim_axes(sp) -> Tuple[str, ...]:
    """The mesh axes one dim's spec entry names (None: none)."""
    if sp is None:
        return ()
    return (sp,) if isinstance(sp, str) else tuple(sp)


def local_shape(d: ParamDef, axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """A leaf's shape on one rank: each dim divided by the sizes of the
    axes its spec names (``axis_sizes``: axis name → size; an axis it
    lacks counts 1), as ``shard_map`` hands each device its block."""
    out = []
    for size, sp in zip(d.shape, d.dim_specs):
        n = 1
        for ax in dim_axes(sp):
            n *= int(axis_sizes.get(ax, 1))
        if size % n:
            raise ValueError(f"dim of {size} does not split over {sp!r} "
                             f"({n} ranks)")
        out.append(size // n)
    return tuple(out)


def take_shard(t: torch.Tensor, d: ParamDef, ctx) -> torch.Tensor:
    """This rank's block of a global leaf ``t`` (a view): every dim cut by
    the rank's index over the axes its spec names (client-major over a
    tuple of axes, as ``ctx.axis_index``)."""
    for dim, sp in enumerate(d.dim_specs):
        axes = dim_axes(sp)
        n = ctx.axis_size(axes)
        if n > 1:
            chunk = t.shape[dim] // n
            t = t.narrow(dim, ctx.axis_index(axes) * chunk, chunk)
    return t


def gather_shard(t: torch.Tensor, d: ParamDef, ctx) -> torch.Tensor:
    """The global leaf from every rank's block (collective over the axes
    its spec names)."""
    for dim, sp in enumerate(d.dim_specs):
        t = ctx.gather_axes(dim_axes(sp), t, axis=dim)
    return t


def shard_params(full, defs, ctx):
    """A global params tree (every rank holding the same one) → this
    rank's shards, each a contiguous copy."""
    return tree_map(lambda t, d: take_shard(t, d, ctx).contiguous(), full,
                    defs)


def gather_params(local, defs, ctx):
    """This rank's shards → the global tree, on every rank (collective:
    every rank calls it)."""
    return tree_map(lambda t, d: gather_shard(t, d, ctx), local, defs)


def count_params(defs) -> int:
    total = 0
    for _, d in leaves_with_paths(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


def ravel(params) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Dict]]:
    """``params`` (nested dict of tensors) → ``(flat, unravel)``.

    ``flat`` is the (d,) concatenation in ``ravel_pytree`` order;
    ``unravel(vec)`` returns a nested dict of VIEWS into ``vec`` in the
    original shapes (writing through them writes ``vec``)."""
    items = list(leaves_with_paths(params))
    paths = [p for p, _ in items]
    shapes = [tuple(leaf.shape) for _, leaf in items]
    sizes = [leaf.numel() for _, leaf in items]
    flat = torch.cat([leaf.reshape(-1) for _, leaf in items])

    def unravel(vec: torch.Tensor) -> Dict:
        parts = torch.split(vec, sizes)
        return unflatten(paths, [p.view(s) for p, s in zip(parts, shapes)])

    return flat, unravel


# -- convenience constructors ------------------------------------------------


def linear(in_dim: int, out_dim: int, *, shard: Optional[str] = None,
           shard_dim: int = 1, dtype="float32") -> ParamDef:
    """A (in, out) weight. ``shard``: mesh axis name for ``shard_dim``."""
    spec = [None, None]
    if shard is not None:
        spec[shard_dim] = shard
    return ParamDef((in_dim, out_dim), scale=in_dim ** -0.5, dtype=dtype,
                    spec=tuple(spec))


def bias(dim: int, *, shard: Optional[str] = None,
         dtype="float32") -> ParamDef:
    return ParamDef((dim,), scale=0.0, dtype=dtype, init="zeros",
                    spec=(shard,))


def norm_scale(dim: int, *, shard: Optional[str] = None) -> ParamDef:
    return ParamDef((dim,), init="ones", spec=(shard,))


def embedding(vocab: int, dim: int, *,
              shard: Optional[str] = None) -> ParamDef:
    """A vocab-sharded (vocab, dim) embedding table."""
    return ParamDef((vocab, dim), scale=1.0, spec=(shard, None))
