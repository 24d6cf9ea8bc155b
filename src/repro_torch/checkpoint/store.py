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

Also home to :class:`EFStore`, a verbatim copy of the reference's
host-side sharded error-feedback store behind ``FedConfig.ef_store``
(numpy and ``threading`` only): per-client EF rows live in lazily
materialized numpy shards with a background prefetch, so FedSim's device
holds the participating cohort's rows, not (m, d). A shard of
``shard_clients`` rows is allocated whole when the first of its clients
is written: at d = 704,266 that is 721 MB a shard, so host memory grows
with the shards touched, up to 256 times the rows ever written.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

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


# ===========================================================================
# Host-side sharded error-feedback store (FedConfig.ef_store)
# ===========================================================================


class _Prefetch:
    """One in-flight async gather: ``buf`` is filled by ``thread``."""

    __slots__ = ("idx", "buf", "thread")

    def __init__(self, idx: np.ndarray):
        self.idx = idx
        self.buf: Optional[np.ndarray] = None
        self.thread: Optional[threading.Thread] = None


class EFStore:
    """Host-side sharded (m, d) error-feedback store (DESIGN.md §scale-out).

    Rows (one fp32 error vector per client) live host-side in fixed-size
    numpy shards of ``shard_clients`` rows each, **lazily materialized**: a
    shard allocates only once one of its clients is first written, so a
    m=10^6 store costs O(clients ever selected)·d, not m·d — untouched
    clients read as the zeros they would hold anyway.

    Per round the driver calls :meth:`gather` for the participating rows
    (-> a dense (n, d) block the jitted round consumes), :meth:`scatter` to
    write the updated rows back, and optionally :meth:`prefetch` to
    assemble the *next* round's rows on a background thread while the
    device computes. A scatter that lands while a prefetch is in flight
    patches the overlapping rows in the prefetched buffer, so a client
    participating in consecutive rounds never reads a stale row
    (property-tested in tests/test_scale_out.py).
    """

    def __init__(self, num_clients: int, d: int, shard_clients: int = 256):
        if shard_clients < 1:
            raise ValueError(f"shard_clients={shard_clients} must be >= 1")
        self.num_clients = int(num_clients)
        self.d = int(d)
        self.shard_clients = int(shard_clients)
        self._shards: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self._pf: Optional[_Prefetch] = None

    @property
    def nbytes(self) -> int:
        """Host bytes actually materialized (lazy shards only)."""
        return sum(s.nbytes for s in self._shards.values())

    def _shard_rows(self, s: int) -> int:
        return min(self.shard_clients,
                   self.num_clients - s * self.shard_clients)

    def _gather_locked(self, idx: np.ndarray) -> np.ndarray:
        out = np.zeros((idx.size, self.d), np.float32)
        for j, c in enumerate(idx):
            s, r = divmod(int(c), self.shard_clients)
            shard = self._shards.get(s)
            if shard is not None:
                out[j] = shard[r]
        return out

    def gather(self, idx) -> np.ndarray:
        """Rows for this round's cohort as a dense (n, d) fp32 block.

        Consumes a matching in-flight :meth:`prefetch` (a non-matching one
        stays queued for the round it was issued for)."""
        idx = np.asarray(idx, np.int64)
        pf = self._pf
        if pf is not None and np.array_equal(pf.idx, idx):
            self._pf = None
            pf.thread.join()
            return pf.buf
        with self._lock:
            return self._gather_locked(idx)

    def prefetch(self, idx) -> None:
        """Start assembling ``gather(idx)`` on a background thread. At most
        one prefetch is in flight; issuing another replaces it."""
        idx = np.asarray(idx, np.int64)
        old = self._pf
        if old is not None and old.thread is not None:
            old.thread.join()
        pf = _Prefetch(idx)

        def work():
            with self._lock:
                pf.buf = self._gather_locked(idx)

        pf.thread = threading.Thread(target=work, daemon=True)
        self._pf = pf
        pf.thread.start()

    def scatter(self, idx, rows) -> None:
        """Write the cohort's updated rows back (allocating shards on first
        touch) and patch any overlapping rows in an in-flight prefetch."""
        idx = np.asarray(idx, np.int64)
        rows = np.asarray(rows, np.float32)
        if rows.shape != (idx.size, self.d):
            raise ValueError(f"scatter rows shape {rows.shape} != "
                             f"({idx.size}, {self.d})")
        pf = self._pf
        if pf is not None:
            pf.thread.join()  # buf is complete before we patch it
        with self._lock:
            for j, c in enumerate(idx):
                s, r = divmod(int(c), self.shard_clients)
                shard = self._shards.get(s)
                if shard is None:
                    shard = self._shards[s] = np.zeros(
                        (self._shard_rows(s), self.d), np.float32)
                shard[r] = rows[j]
            if pf is not None and pf.buf is not None:
                pos = {int(c): j for j, c in enumerate(pf.idx)}
                for j, c in enumerate(idx):
                    p = pos.get(int(c))
                    if p is not None:
                        pf.buf[p] = rows[j]
