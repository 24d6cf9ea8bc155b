"""Per-call dispatch between the CUDA kernels and their plain twins.

Counterpart of ``repro.kernels.ops``. Each public function looks at the
device of the tensors it is given: on CUDA it launches the kernel (built
from ``csrc/`` on first use), on the CPU it runs the plain twin in
:mod:`repro_torch.kernels.ref`. It never falls back from a kernel to its
twin: a kernel that fails to build or launch raises.

The ``*_cuda`` functions are the kernel wrappers themselves. They check
device, dtype, shape and contiguity, allocate outputs with
``torch.empty``, launch on the current stream, raise on a nonzero
``cudaGetLastError()``, and count the launch in :data:`launches`. Called
with CPU tensors they raise.

:class:`KernelImpl` is the mesh round's kernel provider (the JAX package's
``KernelImpl``): the per-leaf selection and fused ingest over the
functions above, each leaf a (1, d_leaf) row with ``rows = [0]``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: kernel name → launches since the last :func:`reset_launches`. A wrapper
#: adds one where it launches its kernel and nowhere else.
launches = {name: 0 for name in _build.SIGNATURES}

_STATE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}
_STATE_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(t, what: str, dtype, shape=None, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise RuntimeError(f"{what}: the CUDA kernel needs a CUDA tensor, "
                           f"got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _launch(name: str, device, *args):
    fn = _build.kernel(name)
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"repro_torch: {name} launch failed with "
                           f"cudaError {rc}")
    launches[name] += 1


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_rows(rows, m: int, what: str = "topk_ef_sparse"):
    """``rows`` name the EF rows a call updates in place: they must lie in
    [0, m) (the kernel would write outside the buffer) and be distinct (the
    kernel's CTAs of a repeated row would race). One host sync."""
    if rows.numel() == 0:
        return
    s = torch.sort(rows).values
    out_of_range, repeated = torch.stack(
        [(s[0] < 0) | (s[-1] >= m), (s[1:] == s[:-1]).any()]).tolist()
    if out_of_range:
        raise ValueError(f"{what}: rows must lie in [0, {m}), got "
                         f"{rows.tolist()}")
    if repeated:
        raise ValueError(f"{what}: rows must be distinct, got "
                         f"{rows.tolist()}")


def _check_ef_args(x, err, rows, what: str):
    """The (c, d) deltas / (m, d) EF buffer / (c,) rows layout shared by
    the error-feedback kernels."""
    if x.dim() != 2 or err.dim() != 2:
        raise ValueError(f"{what}: x is (c, d), err is (m, d)")
    c, d = x.shape
    dev = x.device
    _check(x, f"{what} x", torch.float32)
    _check(err, f"{what} err", torch.float32, (err.shape[0], d), dev)
    _check(rows, f"{what} rows", torch.int64, (c,), dev)


# -- client uplink: blockwise exact top-k + fused error feedback -------------


def topk_ef_sparse(x, err, rows, *, k: int, block: int):
    """Select-once uplink for ``c`` clients; see
    :func:`repro_torch.kernels.ref.topk_ef_sparse` for the contract
    (``err[rows]`` is updated in place; returns ``(vals, idx)`` (c, nb, k)).
    """
    if x.is_cuda:
        return topk_ef_sparse_cuda(x, err, rows, k=k, block=block)
    _check_rows(rows, err.shape[0])
    return ref.topk_ef_sparse(x, err, rows, k=k, block=block)


def topk_ef_sparse_cuda(x, err, rows, *, k: int, block: int,
                        check_rows: bool = True):
    """``check_rows=False`` skips the host-synchronizing check of ``rows``
    (for timing the kernel alone, on rows checked once outside)."""
    _check_ef_args(x, err, rows, "topk_ef_sparse")
    if check_rows:
        _check_rows(rows, err.shape[0])
    c, d = x.shape
    dev = x.device
    if not 0 < block <= 2048 or not 0 < k <= block:
        raise ValueError(f"topk_ef_sparse: need 0 < k <= block <= 2048, got "
                         f"k={k}, block={block}")
    nb = -(-d // block)
    vals = torch.empty((c, nb, k), dtype=torch.float32, device=dev)
    idx = torch.empty((c, nb, k), dtype=torch.int32, device=dev)
    _launch("topk_ef_sparse", dev, _ptr(x), _ptr(err), _ptr(rows),
            _ptr(vals), _ptr(idx), d, block, nb, k, c)
    return vals, idx


def topk_ef(x, err, rows, *, k: int, block: int):
    """Dense-hat blockwise top-k with error feedback for ``c`` clients; see
    :func:`repro_torch.kernels.ref.topk_ef` for the contract (``err[rows]``
    becomes ``tot - hat`` in place; returns the (c, d) hat)."""
    if x.is_cuda:
        return topk_ef_cuda(x, err, rows, k=k, block=block)
    _check_rows(rows, err.shape[0], "topk_ef")
    return ref.topk_ef(x, err, rows, k=k, block=block)


def topk_ef_cuda(x, err, rows, *, k: int, block: int,
                 check_rows: bool = True):
    """``check_rows`` as in :func:`topk_ef_sparse_cuda`."""
    _check_ef_args(x, err, rows, "topk_ef")
    if check_rows:
        _check_rows(rows, err.shape[0], "topk_ef")
    if not 0 < block <= 2048 or not 0 < k <= block:
        raise ValueError(f"topk_ef: need 0 < k <= block <= 2048, got "
                         f"k={k}, block={block}")
    c, d = x.shape
    nb = -(-d // block)
    hat = torch.empty((c, d), dtype=torch.float32, device=x.device)
    _launch("topk_ef", x.device, _ptr(x), _ptr(err), _ptr(rows), _ptr(hat),
            d, block, nb, k, c)
    return hat


# -- client uplink: scaled sign + fused error feedback -----------------------


def sign_ef(x, err, rows):
    """Scaled sign with error feedback for ``c`` clients; see
    :func:`repro_torch.kernels.ref.sign_ef` for the contract (``err[rows]``
    becomes ``tot - hat`` in place; returns the (c, d) hat)."""
    if x.is_cuda:
        return sign_ef_cuda(x, err, rows)
    _check_rows(rows, err.shape[0], "sign_ef")
    return ref.sign_ef(x, err, rows)


#: (device index, stream) → ``sign_ef``'s per-client arrival counts and
#: epochs, zeroed once when made. Each call leaves every count at 0 (the
#: kernel resets it) and only moves epochs, so no call zeroes the buffer;
#: one per stream, so calls on two streams never share one.
_sign_arrivals_of = {}


def _sign_arrivals(dev, c: int):
    """The arrival buffer (at least 2c int32) for a ``sign_ef`` call of
    ``c`` clients on the current stream of ``dev``."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _sign_arrivals_of.get(key)
    if buf is None or buf.numel() < 2 * c:
        with torch.cuda.device(dev):
            buf = torch.zeros(2 * max(c, 64), dtype=torch.int32, device=dev)
        _sign_arrivals_of[key] = buf
    return buf


def sign_ef_cuda(x, err, rows, *, check_rows: bool = True):
    """``check_rows`` as in :func:`topk_ef_sparse_cuda`. One cooperative
    launch, whose grid the entry point sizes from the device's SM count,
    opt-in shared memory and occupancy; a grid the card cannot hold at once
    is refused, and this raises."""
    _check_ef_args(x, err, rows, "sign_ef")
    if check_rows:
        _check_rows(rows, err.shape[0], "sign_ef")
    c, d = x.shape
    nb = -(-d // ref.SIGN_BLOCK)
    dev = x.device
    hat = torch.empty((c, d), dtype=torch.float32, device=dev)
    partials = torch.empty((c, nb), dtype=torch.float32, device=dev)
    _launch("sign_ef", dev, _ptr(x), _ptr(err), _ptr(rows), _ptr(hat),
            _ptr(partials), _ptr(_sign_arrivals(dev, c)), d, nb, c)
    return hat


# -- wire: n-bit packing -----------------------------------------------------

#: value dtype → the bitpack entry points' kind code
_PACK_KIND = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}


def _check_nbits(what: str, nbits: int):
    if not 1 <= nbits <= 32:
        raise ValueError(f"{what}: nbits must be in [1, 32], got {nbits}")


def _check_pack_vals(vals, nbits: int, what: str, fused: bool):
    kinds = (torch.uint8, torch.int32) + ((torch.float32,) if fused else ())
    if not isinstance(vals, torch.Tensor) or vals.dtype not in kinds:
        names = "uint8, int32 or float32" if fused else "uint8 or int32"
        raise TypeError(f"{what}: values must be a {names} tensor, got "
                        f"{getattr(vals, 'dtype', type(vals))}")
    _check(vals, f"{what} vals", vals.dtype)
    _check_nbits(what, nbits)
    if vals.dtype == torch.float32 and nbits != 1:
        raise ValueError(f"{what}: float32 totals pack their sign predicate "
                         f"at nbits=1, got nbits={nbits}")


def _check_unpack_dtype(what: str, nbits: int, dtype, fused: bool):
    if dtype == torch.float32 and fused:
        if nbits != 1:
            raise ValueError(f"{what}: float32 (scaled signs) needs nbits=1, "
                             f"got {nbits}")
        return
    if dtype not in (torch.uint8, torch.int32) or (
            dtype == torch.uint8 and nbits > 8):
        raise TypeError(f"{what}: dtype {dtype} cannot hold {nbits}-bit "
                        f"values")


def _check_block(buf, what: str, col: int, nbytes: int):
    """A (c, W) uint8 block whose rows are contiguous (any row stride) and
    hold ``nbytes`` from column ``col``."""
    if not isinstance(buf, torch.Tensor) or buf.dim() != 2:
        raise ValueError(f"{what}: expected a (c, W) uint8 tensor")
    if not buf.is_cuda:
        raise RuntimeError(f"{what}: the CUDA kernel needs a CUDA tensor, "
                           f"got one on {buf.device}")
    if buf.dtype != torch.uint8:
        raise TypeError(f"{what}: dtype {buf.dtype}, expected torch.uint8")
    if buf.stride(1) != 1 or buf.stride(0) < buf.shape[1]:
        raise ValueError(f"{what}: rows must be contiguous and apart")
    if col < 0 or col + nbytes > buf.shape[1]:
        raise ValueError(f"{what}: columns [{col}, {col + nbytes}) do not "
                         f"fit rows of {buf.shape[1]} bytes")


def pack_uint(vals, nbits: int):
    """MSB-first ``nbits``-bit packing of uint8 or int32 (uint32 bit
    pattern) values → uint8 bytes; the contract of
    :func:`repro_torch.kernels.ref.pack_uint`."""
    if vals.is_cuda:
        return pack_uint_cuda(vals, nbits)
    return ref.pack_uint(vals, nbits)


def pack_uint_cuda(vals, nbits: int):
    """One row of :func:`pack_uint_rows_cuda`."""
    _check_pack_vals(vals, nbits, "pack_uint", fused=False)
    count = vals.numel()
    out = torch.empty((1, (count * nbits + 7) // 8), dtype=torch.uint8,
                      device=vals.device)
    if count:
        _launch("pack_uint", vals.device, _ptr(vals), count,
                _PACK_KIND[vals.dtype], _ptr(out), out.shape[1], 0, count,
                nbits, 1)
    return out[0]


def pack_uint_rows(vals, nbits: int, out, col: int = 0):
    """Each row of ``vals`` (c, count) packed on its own into
    ``out[r, col:col + ceil(count·nbits/8)]`` of the (c, W) uint8 block
    ``out``, IN PLACE (no other byte of ``out`` changes); returns ``out``.
    The contract of :func:`repro_torch.kernels.ref.pack_uint_rows`: uint8
    or int32 values, or, at ``nbits=1``, float32 totals packed as their
    ``>= 0`` predicate."""
    if vals.is_cuda:
        return pack_uint_rows_cuda(vals, nbits, out, col)
    return ref.pack_uint_rows(vals, nbits, out, col)


def pack_uint_rows_cuda(vals, nbits: int, out, col: int = 0):
    """One launch for all c rows."""
    _check_pack_vals(vals, nbits, "pack_uint_rows", fused=True)
    if vals.dim() != 2:
        raise ValueError("pack_uint_rows: vals is (c, count)")
    c, count = vals.shape
    _check_block(out, "pack_uint_rows out", col, (count * nbits + 7) // 8)
    if out.shape[0] != c or out.device != vals.device:
        raise ValueError(f"pack_uint_rows: out is {tuple(out.shape)} on "
                         f"{out.device}, expected {c} rows on {vals.device}")
    if c and count:
        _launch("pack_uint", vals.device, _ptr(vals), count,
                _PACK_KIND[vals.dtype], _ptr(out), out.stride(0), col, count,
                nbits, c)
    return out


def unpack_uint(buf, nbits: int, count: int, dtype=torch.int32):
    """Inverse of :func:`pack_uint`: ``count`` values as int32 (uint32 bit
    patterns) or, for nbits <= 8, uint8; the contract of
    :func:`repro_torch.kernels.ref.unpack_uint`."""
    if buf.is_cuda:
        return unpack_uint_cuda(buf, nbits, count, dtype)
    return ref.unpack_uint(buf, nbits, count, dtype)


def unpack_uint_cuda(buf, nbits: int, count: int, dtype=torch.int32):
    """One row of :func:`unpack_uint_rows_cuda`; bytes past the end of
    ``buf`` read as 0."""
    _check(buf, "unpack_uint buf", torch.uint8)
    _check_nbits("unpack_uint", nbits)
    _check_unpack_dtype("unpack_uint", nbits, dtype, fused=False)
    out = torch.empty((1, count), dtype=dtype, device=buf.device)
    if count:
        _launch("unpack_uint", buf.device, _ptr(buf), buf.numel(), 0,
                buf.numel(), _ptr(out), count, _PACK_KIND[dtype], count,
                nbits, 1, 0, 0)
    return out[0]


def unpack_uint_rows(buf, col: int, nbits: int, count: int,
                     dtype=torch.int32, *, scale_col=None,
                     scale_block: int = 0):
    """Inverse of :func:`pack_uint_rows`: ``count`` values from
    ``buf[r, col:]`` of each row of the (c, W) uint8 block → (c, count)
    int32 or (nbits <= 8) uint8; or, at ``nbits=1`` with ``dtype=float32``,
    the scaled signs ``scale_r · (bit ? 1 : -1)``, ``scale_r`` the fp32 at
    ``buf[r, scale_col:scale_col + 4]`` (with ``scale_block > 0``, value i
    takes the scale at ``scale_col + 4·(i // scale_block)``). The contract
    of :func:`repro_torch.kernels.ref.unpack_uint_rows`."""
    if buf.is_cuda:
        return unpack_uint_rows_cuda(buf, col, nbits, count, dtype,
                                     scale_col=scale_col,
                                     scale_block=scale_block)
    return ref.unpack_uint_rows(buf, col, nbits, count, dtype,
                                scale_col=scale_col, scale_block=scale_block)


def unpack_uint_rows_cuda(buf, col: int, nbits: int, count: int,
                          dtype=torch.int32, *, scale_col=None,
                          scale_block: int = 0):
    """One launch for all c rows."""
    _check_nbits("unpack_uint_rows", nbits)
    _check_unpack_dtype("unpack_uint_rows", nbits, dtype, fused=True)
    nbytes = (count * nbits + 7) // 8
    _check_block(buf, "unpack_uint_rows buf", col, nbytes)
    c = buf.shape[0]
    if dtype == torch.float32:
        if scale_col is None or scale_block < 0:
            raise ValueError("unpack_uint_rows: float32 needs scale_col and "
                             "scale_block >= 0")
        nsc = 1 if scale_block == 0 else -(-count // scale_block)
        _check_block(buf, "unpack_uint_rows scales", scale_col, 4 * nsc)
    out = torch.empty((c, count), dtype=dtype, device=buf.device)
    if c and count:
        _launch("unpack_uint", buf.device, _ptr(buf), buf.stride(0), col,
                nbytes, _ptr(out), count, _PACK_KIND[dtype], count, nbits, c,
                scale_col or 0, scale_block)
    return out


# -- server: one-pass fused ingest -------------------------------------------


def fedams_ingest(x, m, v, vhat, vals, idx, v_scale=None, vh_scale=None, *,
                  n_div, eta: float, beta1: float, beta2: float, eps: float,
                  option: int = 1, block: int = 2048,
                  state_dtype: str = "float32"):
    """Fused scatter-mean + FedAMS step; the contract of
    :func:`repro_torch.kernels.ref.fedams_ingest_ref`."""
    kw = dict(n_div=n_div, eta=eta, beta1=beta1, beta2=beta2, eps=eps,
              option=option, block=block, state_dtype=state_dtype)
    if x.is_cuda:
        return fedams_ingest_cuda(x, m, v, vhat, vals, idx, v_scale,
                                  vh_scale, **kw)
    return ref.fedams_ingest_ref(x, m, v, vhat, vals, idx, v_scale, vh_scale,
                                 **kw)


def fedams_ingest_cuda(x, m, v, vhat, vals, idx, v_scale=None, vh_scale=None,
                       *, n_div, eta: float, beta1: float, beta2: float,
                       eps: float, option: int = 1, block: int = 2048,
                       state_dtype: str = "float32"):
    if state_dtype not in _STATE_CODES:
        raise ValueError(f"fedams_ingest: state_dtype {state_dtype!r}")
    if option not in (1, 2):
        raise ValueError(f"fedams_ingest: option {option!r}")
    if block * 4 * (2 if state_dtype == "int8" else 1) > 200 * 1024:
        raise ValueError(f"fedams_ingest: block={block} exceeds shared memory")
    dev = x.device
    d = x.shape[0]
    _check(x, "fedams_ingest x", torch.float32, (d,))
    _check(m, "fedams_ingest m", torch.float32, (d,), dev)
    if vals.dim() != 3:
        raise ValueError("fedams_ingest: vals/idx are (n, nb, k)")
    n, nb, k = vals.shape
    if nb != -(-d // block):
        raise ValueError(f"fedams_ingest: nb={nb} != ceil(d={d}/{block})")
    _check(vals, "fedams_ingest vals", torch.float32, (n, nb, k), dev)
    _check(idx, "fedams_ingest idx", torch.int32, (n, nb, k), dev)
    sdt = _STATE_TORCH[state_dtype]
    slen = nb * block if state_dtype == "int8" else d
    _check(v, "fedams_ingest v", sdt, (slen,), dev)
    _check(vhat, "fedams_ingest vhat", sdt, (slen,), dev)
    x_out = torch.empty_like(x)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    vh_out = torch.empty_like(vhat)
    vs_out = vhs_out = None
    if state_dtype == "int8":
        _check(v_scale, "fedams_ingest v_scale", torch.float32, (nb,), dev)
        _check(vh_scale, "fedams_ingest vh_scale", torch.float32, (nb,), dev)
        vs_out = torch.empty_like(v_scale)
        vhs_out = torch.empty_like(vh_scale)
    else:
        v_scale = vh_scale = None
    _launch("fedams_ingest", dev, _ptr(x), _ptr(m), _ptr(v), _ptr(vhat),
            _ptr(vals), _ptr(idx), _ptr(v_scale), _ptr(vh_scale),
            _ptr(x_out), _ptr(m_out), _ptr(v_out), _ptr(vh_out),
            _ptr(vs_out), _ptr(vhs_out), d, block, n, nb, k,
            float(n_div), float(beta1), float(1.0 - beta1), float(beta2),
            float(1.0 - beta2), float(eta), float(eps), int(option),
            _STATE_CODES[state_dtype])
    if state_dtype == "int8":
        return x_out, m_out, v_out, vh_out, vs_out, vhs_out
    return x_out, m_out, v_out, vh_out


# -- server: two-pass elementwise update -------------------------------------


def fedams_update(x, m, v, vhat, delta, *, eta: float, beta1: float,
                  beta2: float, eps: float, option: int = 1):
    """Elementwise FedAMS step on (N,) fp32 vectors → ``(x, m, v, vhat)``;
    the contract of :func:`repro_torch.kernels.ref.fedams_update_ref`."""
    kw = dict(eta=eta, beta1=beta1, beta2=beta2, eps=eps, option=option)
    if x.is_cuda:
        return fedams_update_cuda(x, m, v, vhat, delta, **kw)
    return ref.fedams_update_ref(x, m, v, vhat, delta, **kw)


def fedams_update_cuda(x, m, v, vhat, delta, *, eta: float, beta1: float,
                       beta2: float, eps: float, option: int = 1):
    if option not in (1, 2):
        raise ValueError(f"fedams_update: option {option!r}")
    n = x.numel()
    dev = x.device
    for t, what in ((x, "x"), (m, "m"), (v, "v"), (vhat, "vhat"),
                    (delta, "delta")):
        _check(t, f"fedams_update {what}", torch.float32, (n,), dev)
    outs = [torch.empty_like(x) for _ in range(4)]
    _launch("fedams_update", dev, _ptr(x), _ptr(m), _ptr(v), _ptr(vhat),
            _ptr(delta), *(_ptr(o) for o in outs), n, float(beta1),
            float(1.0 - beta1), float(beta2), float(1.0 - beta2), float(eta),
            float(eps), int(option))
    return tuple(outs)


# -- the mesh round's kernel provider ----------------------------------------


@dataclass(frozen=True)
class KernelImpl:
    """Plugs into ``core.mesh.build_fed_round(kernel_impl=...)`` for the
    two stages whose kernel computes a different function from the plain
    path's: the select-once uplink (``topk_ef_sparse`` against
    ``Compressor.select``, same contract, bit-identical) and the one-pass
    fused ingest (``fedams_ingest``). A leaf is flattened to one
    (1, d_leaf) row of an EF buffer that is a copy of its error (the
    kernel updates its row in place; the mask decides afterwards whether
    the copy is kept), ``rows = [0]``. The dense-hat EF and the two-pass
    server step need no provider: ``ef_compress_masked`` and
    ``server_update`` already launch ``topk_ef``/``sign_ef`` and
    ``fedams_update`` on CUDA tensors.

    ``device`` is where the round's tensors live (None: CUDA).
    :attr:`compiled` — what ``mesh_sparse_impl="auto"`` and
    ``fused_ingest="auto"`` key off — is true on CUDA, where the functions
    above launch the kernels; on the CPU they run the twins, as the JAX
    ``KernelImpl`` runs the Pallas interpreter off TPU."""

    block: int = 2048
    device: Optional[object] = None

    @property
    def compiled(self) -> bool:
        return torch.device(self.device or "cuda").type == "cuda"

    @staticmethod
    def _row(x, err):
        rows = torch.zeros(1, dtype=torch.int64, device=x.device)
        return (x.reshape(1, -1).float().contiguous(),
                err.reshape(1, -1).float().clone(), rows)

    @staticmethod
    def _call(fn, fn_cuda, x, *args, **kw):
        """``fn`` on the CPU (the twin), ``fn_cuda`` on CUDA without the
        host-synchronizing row check: ``rows = [0]`` of a one-row buffer
        is valid by construction."""
        if x.is_cuda:
            return fn_cuda(x, *args, check_rows=False, **kw)
        return fn(x, *args, **kw)

    # -- the select-once uplink ---------------------------------------
    def topk_select_leaf(self, ratio: float, x, err):
        """Fused EF + compacted selection for one leaf (``topk_ef_sparse``):
        returns ``(Selection, new_err)``, the Selection's ``idx`` flat
        positions in the leaf's zero-padded block domain (entries past
        ``x.numel()`` carry 0.0), ``new_err`` in ``err``'s shape."""
        from repro_torch.core.compressors import Selection, block_layout
        x1, e1, rows = self._row(x, err)
        bs, _ = block_layout(x1.shape[1], self.block)
        k = max(1, int(round(ratio * bs)))
        vals, idx = self._call(topk_ef_sparse, topk_ef_sparse_cuda, x1, e1,
                               rows, k=k, block=bs)
        return (Selection(vals=vals.reshape(-1), idx=idx.reshape(-1)),
                e1.reshape(err.shape))

    def topk_select_tree(self, ratio: float, delta, err, mask):
        """The kernel sibling of ``core.stages.topk_select_tree`` (same
        contract, bit-identical selection and EF)."""
        from repro_torch.core.stages import select_tree
        return select_tree(
            lambda d, e: self.topk_select_leaf(ratio, d, e), delta, err,
            mask)

    # -- server ----------------------------------------------------------
    def fedams_ingest_tree(self, fed, st, params, sels, n_div, gather):
        """Kernel-routed one-pass server ingest: per leaf, gather the
        compacted client Selections and run ``fedams_ingest``
        (``core.server_opt.server_ingest_tree`` with ``impl="kernel"``)."""
        from repro_torch.core.server_opt import server_ingest_tree
        return server_ingest_tree(fed, st, params, sels, n_div, gather,
                                  block=self.block, impl="kernel")
