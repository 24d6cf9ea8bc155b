"""Minimal durable checkpointing: a flattened tree → ``arrays.npz`` + a
JSON manifest.

Counterpart of ``repro.checkpoint.store``'s ``save_pytree``/
``load_pytree``, writing the same files: leaves are keyed by jax's
``keystr`` of their path (``['k']`` for a dict key, dicts in sorted key
order; ``.field`` for a NamedTuple; ``[i]`` for a list or tuple), stored
as ``a0``, ``a1``, … in that order, and the manifest records each key's
shape and dtype name. So a checkpoint either package writes of the same
state holds the same keys, shapes, dtypes and bytes, and either package
reads it (tests/test_torch_checkpoint.py). A bfloat16 leaf is written as
numpy writes jax's bfloat16 — its raw 2-byte words, ``|V2`` in the npz,
``bfloat16`` in the manifest — so neither package restores one: the
manifest-vs-file dtype check refuses it (ROADMAP Queue 3 item 7).

Writes are atomic (tmp + rename), so an interrupted save never corrupts
the previous checkpoint. A restore checks the structure, each shape, and
each dtype against the manifest and against the restore target before it
returns anything, with the reference's messages.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in jax's flattening order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, leaf in enumerate(tree):
            yield from _items(leaf, f"{prefix}[{i}]")
    elif tree is not None:       # None is an empty subtree, as in jax
        yield prefix, tree


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(like, dict):
        out = {key: _rebuild(like[key], leaves) for key in sorted(like)}
        return {key: out[key] for key in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(leaf, leaves) for leaf in like)
    if like is None:
        return None
    return next(leaves)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array written to the npz, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:    # numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_pytree(path: str, tree, extra_meta: Dict[str, Any] | None = None):
    """Save ``tree`` (nested dicts, NamedTuples, lists or tuples of
    tensors, numpy arrays or Python numbers) to ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    flat = [(key, _host(leaf)) for key, leaf in _items(tree)]
    arrays = {f"a{i}": arr for i, (_, (arr, _)) in enumerate(flat)}
    manifest = {
        "keys": [key for key, _ in flat],
        "shapes": [list(arr.shape) for _, (arr, _) in flat],
        "dtypes": [name for _, (_, name) in flat],
        "meta": extra_meta or {},
    }
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json.tmp"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(path, "manifest.json.tmp"),
               os.path.join(path, "manifest.json"))


def load_pytree(path: str, like) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``. Returns ``(tree, meta)``: a
    leaf whose ``like`` is a tensor comes back as a tensor on that tensor's
    device, any other as a numpy array."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = dict(_items(like))
    if list(want.keys()) != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(want.keys())
        raise ValueError(f"checkpoint structure mismatch; differing keys: "
                         f"{sorted(missing)[:5]} ...")
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (key, like_leaf) in enumerate(want.items()):
            arr = data[f"a{i}"]
            shape = tuple(like_leaf.shape) if isinstance(
                like_leaf, torch.Tensor) else np.shape(like_leaf)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {shape}")
            want_dt = _dtype_name(like_leaf)
            if str(arr.dtype) != manifest["dtypes"][i]:
                raise ValueError(
                    f"dtype mismatch for {key}: arrays.npz holds {arr.dtype} "
                    f"but the manifest recorded {manifest['dtypes'][i]} — the "
                    f"checkpoint files disagree (corrupt or mixed save)")
            if str(arr.dtype) != want_dt:
                raise ValueError(
                    f"dtype mismatch for {key}: checkpoint holds {arr.dtype}, "
                    f"restore target expects {want_dt} — a silent cast here "
                    f"would corrupt optimizer state (e.g. int8 blockscale "
                    f"payloads read as counts)")
            if isinstance(like_leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(like_leaf.device)
            leaves.append(arr)
    return _rebuild(like, iter(leaves)), manifest["meta"]
