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

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    scale: float = 1.0
    dtype: str = "float32"
    init: str = "normal"      # normal | zeros | ones


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    """``(path, leaf)`` pairs in ``ravel_pytree`` order: sorted dict keys,
    depth first."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _unflatten(paths: List[Tuple[str, ...]], leaves: List) -> Dict:
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def init_params(defs, generator: torch.Generator, device="cpu") -> Dict:
    """Concretely initialize a defs tree. Leaves are drawn in ravel order
    from ``generator`` (a CPU ``torch.Generator``) and then moved to
    ``device``, so the init does not depend on the device. The numbers
    differ from ``repro``'s (a JAX PRNG); parity runs convert the JAX init
    instead (``repro_torch.convert``)."""
    paths, leaves = [], []
    for path, d in leaves_with_paths(defs):
        dtype = getattr(torch, d.dtype)
        if d.init == "zeros":
            arr = torch.zeros(d.shape, dtype=dtype)
        elif d.init == "ones":
            arr = torch.ones(d.shape, dtype=dtype)
        else:
            arr = torch.randn(d.shape, generator=generator, dtype=dtype) * d.scale
        paths.append(path)
        leaves.append(arr.to(device))
    return _unflatten(paths, leaves)


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
        return _unflatten(paths, [p.view(s) for p, s in zip(parts, shapes)])

    return flat, unravel


# -- convenience constructors ------------------------------------------------


def linear(in_dim: int, out_dim: int, dtype="float32") -> ParamDef:
    """A (in, out) weight."""
    return ParamDef((in_dim, out_dim), scale=in_dim ** -0.5, dtype=dtype)


def bias(dim: int, dtype="float32") -> ParamDef:
    return ParamDef((dim,), scale=0.0, dtype=dtype, init="zeros")


def norm_scale(dim: int) -> ParamDef:
    return ParamDef((dim,), init="ones")
