"""Op-level cost analysis of one rank's step.

Counterpart of ``repro.launch.hlo_analysis``. The port has no HLO: a step
runs eagerly, one aten op at a time, so :class:`OpCost` (a
``TorchDispatchMode``) records every op the step dispatches and charges it
by the reference's conventions, adapted to eager execution, into a
:class:`StepCost`: ``HloCost``'s fields under the same names (``flops``,
``bytes``, ``rw_bytes``, ``coll_bytes``, ``coll_count``,
``weighted_coll_bytes``), the ops counted, the kernel launches and the
memory record.
It runs on ``meta`` tensors (the dry run: no data, no card) and on real
ones (a card's run of the same step, counted alike).

Conventions (held fixed so deltas are comparable):
  * FLOPs: 2 · prod(out_shape) · prod(contracted dims) per matmul-class
    op (``torch.utils.flop_counter``'s registry: mm, addmm, bmm, baddbmm,
    convolutions, attention); elementwise FLOPs are ignored.
  * Bytes (HBM traffic proxy):
      - matmul-class: lhs + rhs + output bytes (an addmm's bias is not
        charged, as the reference's dot has none);
      - in-place slice writes — ``copy_`` (into a view or a whole
        tensor), ``index_put_``, ``index_add_``, ``index_copy_``,
        ``scatter_``/``scatter_add_``: the UPDATE's bytes, as
        ``dynamic-update-slice`` is charged;
      - reductions (sum, mean, amax, argmax, ...): first operand +
        output bytes;
      - views (view, expand, slice, select, transpose, permute, detach,
        ``as_strided``, ``_unsafe_view``, ...) and allocations that write
        nothing (``empty``, ``empty_like``, ``empty_strided``,
        ``new_empty``): 0, as the reference's bitcast,
        get-tuple-element and parameter are;
      - everything else: output bytes.
  * ``rw_bytes`` charges reads and writes: a matmul lhs + rhs + output; a
    slice write 2 × the update; a reduction its first operand + output;
    views and empty allocations 0; a collective 2 × its payload; anything
    else its output + every tensor operand.
  * Eager torch has no fusions: every op is charged where it runs, its
    intermediates included (the reference charges a fusion's output
    only). The port's bytes are therefore at least the reference's for
    the same step.
  * Collectives are charged where ``sharding/rules.ParallelContext`` runs
    them (:func:`record_collective`), keyed by the reference's kind names
    (``all-reduce``, ``all-gather``, ``reduce-scatter``) and the port's
    ``broadcast`` (the model-axis broadcast that keeps replicated leaves
    equal, which the reference does not need): payload = the output's
    bytes; reduce-scatter its full input (``hlo_analysis``'s convention).
    The process group's own ops (and the profiler's range markers) are
    not charged. On ``meta`` tensors the context charges a collective and
    moves nothing.
  * Kernel launches are charged where ``kernels/ops._launch`` launches
    them (:func:`record_launch`), by name, with the bytes of their bound:
    each input read once, each output written once. On ``meta`` tensors a
    kernel wrapper checks and allocates as on the card and charges the
    launch it would make.
  * Memory: each output storage is live from the op that makes it until
    it is freed (``weakref.finalize`` on its storage). ``argument_size``
    is the step's inputs, ``output_size`` its outputs that are not
    inputs, ``temp_size`` the peak of live bytes minus the arguments —
    the counterpart of ``compiled.memory_analysis()``
    (``generated_code_size`` is None: nothing is generated).
  * Trip counts: a long sequential loop (the sLSTM's steps,
    ``models/xlstm.py``) asks :func:`loop_trips` how many steps to run. On
    real tensors it runs them all. On ``meta`` under :func:`analyze` it
    runs ``n`` and then ``n + 1`` (the outputs padded to the full length
    either way), and every count is extrapolated to the full length: each
    step's forward and backward ops are the same, so the counts are
    affine in the steps run, and the extrapolation equals a full trace to
    the integer. The memory peak is extrapolated alike (an estimate).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

#: ops that write a slice of their first operand in place: the index of
#: the update operand
_SLICE_WRITES = {
    _aten.copy_: 1, _aten.index_put_: 2, _aten.index_add_: 3,
    _aten.index_copy_: 3, _aten.scatter_: 3, _aten.scatter_add_: 3,
    _aten.scatter_reduce_: 3,
}

_REDUCTIONS = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.argmax, _aten.argmin, _aten.prod, _aten.var, _aten.std,
    _aten.var_mean, _aten.std_mean, _aten.linalg_vector_norm, _aten.norm,
    _aten.logsumexp, _aten.any, _aten.all, _aten.count_nonzero,
    _aten.nansum, _aten.aminmax,
}

#: allocations that write nothing
_EMPTY = {_aten.empty, _aten.empty_like, _aten.empty_strided,
          _aten.new_empty, _aten.new_empty_strided}

#: matmul-class ops whose first operand is an added bias, not charged
_BIASED = {_aten.addmm, _aten.baddbmm}

#: ops not charged: the process group's own (charged by
#: :func:`record_collective`) and the profiler's range markers
_UNCHARGED = ("c10d", "_c10d_functional", "c10d_functional", "profiler")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _sum_bytes(x) -> int:
    return sum(_nbytes(t) for t in _tensors(x))


@dataclass
class StepCost:
    """A step's counts (``hlo_analysis.HloCost``'s fields under the same
    names, and more); the memory record is filled when the step ends."""
    ops: int = 0
    flops: int = 0
    bytes: int = 0
    rw_bytes: int = 0
    coll_bytes: Dict[str, int] = field(default_factory=dict)
    coll_count: Dict[str, int] = field(default_factory=dict)
    launch_count: Dict[str, int] = field(default_factory=dict)
    launch_bytes: Dict[str, int] = field(default_factory=dict)
    memory: dict = field(default_factory=dict)

    @property
    def weighted_coll_bytes(self) -> float:
        return sum(b * (2.0 if k == "all-reduce" else 1.0)
                   for k, b in self.coll_bytes.items())


class OpCost(TorchDispatchMode):
    """Records every aten op dispatched inside ``with OpCost() as rec:``
    and charges it into ``rec.cost`` (a :class:`StepCost`) by the module's
    conventions; collectives and kernel launches reach it through
    :func:`record_collective` and :func:`record_launch`. ``max_trips`` > 0
    caps a meta trace's loops (:func:`loop_trips`); :func:`analyze`
    extrapolates."""

    def __init__(self, *, max_trips: int = 0):
        super().__init__()
        self.cost = StepCost()
        self.max_trips = max_trips
        self.loop_lengths = set()       # full lengths of the loops capped
        self._args = set()
        self._arg_bytes = 0
        self._live = 0
        self._peak = 0
        self._storages = {}             # storage key -> bytes (live)

    # -- memory ------------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> Optional[int]:
        """Track ``t``'s storage from now until it is freed; returns its
        key (None if it was tracked already)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return None
        n = st.nbytes()
        self._storages[key] = n
        self._live += n
        self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key) -> None:
        self._live -= self._storages.pop(key, 0)

    def add_arguments(self, args) -> None:
        """The step's inputs: live throughout, ``argument_size``."""
        for t in _tensors(args):
            key = self._hold(t)
            if key is not None:
                self._args.add(key)
                self._arg_bytes += self._storages[key]

    def close(self, out) -> StepCost:
        """The memory record of a step that returned ``out``."""
        outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(out)}
        self.cost.memory = {
            "argument_size": self._arg_bytes,
            "output_size": sum(n for k, n in outs.items()
                               if k not in self._args),
            "temp_size": self._peak - self._arg_bytes,
            "generated_code_size": None}
        return self.cost

    # -- charging ---------------------------------------------------------
    def charge_collective(self, kind: str, nbytes: int) -> None:
        c = self.cost
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + int(nbytes)
        c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
        c.bytes += int(nbytes)
        c.rw_bytes += 2 * int(nbytes)

    def charge_launch(self, name: str, nbytes: int) -> None:
        c = self.cost
        c.launch_count[name] = c.launch_count.get(name, 0) + 1
        c.launch_bytes[name] = c.launch_bytes.get(name, 0) + int(nbytes)
        c.bytes += int(nbytes)
        c.rw_bytes += int(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _UNCHARGED:
            return out
        self.cost.ops += 1
        self._charge(func, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        c = self.cost
        packet = func.overloadpacket
        if func.is_view or packet in _EMPTY or packet is _aten._unsafe_view:
            return
        out_b = _sum_bytes(out)
        if packet in flop_registry:
            c.flops += int(flop_registry[packet](*args, **kwargs,
                                                 out_val=out))
            ops = args[1:] if packet in _BIASED else args
            b = _sum_bytes(ops) + out_b
            c.bytes += b
            c.rw_bytes += b
            return
        if packet in _SLICE_WRITES:
            i = _SLICE_WRITES[packet]
            upd = args[i] if len(args) > i else kwargs.get("src", 0)
            ub = _nbytes(upd)
            c.bytes += ub
            c.rw_bytes += 2 * ub
            return
        if packet in _REDUCTIONS:
            b = _nbytes(args[0]) + out_b
            c.bytes += b
            c.rw_bytes += b
            return
        c.bytes += out_b
        c.rw_bytes += out_b + _sum_bytes((args, kwargs))


# ---------------------------------------------------------------------------
# Hooks for the choke points (collectives, kernel launches, loops)
# ---------------------------------------------------------------------------


def _recorders():
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCost)]


def record_collective(kind: str, nbytes: int) -> None:
    """Charge a collective of ``kind`` moving ``nbytes`` to every active
    recorder (``sharding/rules.py`` calls it at each collective)."""
    for rec in _recorders():
        rec.charge_collective(kind, nbytes)


def record_launch(name: str, nbytes: int) -> None:
    """Charge a kernel launch whose bound moves ``nbytes`` to every active
    recorder (``kernels/ops.py::_launch`` calls it)."""
    for rec in _recorders():
        rec.charge_launch(name, nbytes)


def loop_trips(length: int, t: torch.Tensor) -> int:
    """How many steps a sequential loop of ``length`` steps over ``t``
    runs: all of them, unless ``t`` is ``meta`` and an active recorder
    caps its loops (:func:`analyze`)."""
    if not t.is_meta:
        return length
    cap = 0
    for rec in _recorders():
        if rec.max_trips:
            cap = rec.max_trips
            rec.loop_lengths.add(length)
    return min(length, cap) if cap else length


def _measure(fn, args, max_trips: int) -> OpCost:
    rec = OpCost(max_trips=max_trips)
    with rec:
        rec.add_arguments(args)
        rec.close(fn(*args))
    return rec


def measure(fn, *args) -> StepCost:
    """The counts of one full run of ``fn(*args)``: no loop capped."""
    return _measure(fn, args, 0).cost


#: the steps a capped meta trace runs (and one more)
TRACE_TRIPS = 2


def _extrapolate(a, b, steps: int):
    """``a`` at n trips, ``b`` at n + 1: the value at n + ``steps``."""
    if isinstance(a, dict):
        return {k: _extrapolate(a.get(k, 0), b.get(k, 0), steps)
                for k in set(a) | set(b)}
    if a is None:
        return None
    return a + steps * (b - a)


def analyze(fn, *args) -> StepCost:
    """The counts of ``fn(*args)``. On ``meta`` inputs a long sequential
    loop is traced at ``TRACE_TRIPS`` and ``TRACE_TRIPS + 1`` steps and
    every count extrapolated to its full length (the module's trip-count
    convention); otherwise one full run."""
    meta = any(t.is_meta for t in _tensors(args))
    rec = _measure(fn, args, TRACE_TRIPS if meta else 0)
    if not rec.loop_lengths:
        return rec.cost
    if len(rec.loop_lengths) > 1:
        raise ValueError(f"loops of several lengths {sorted(rec.loop_lengths)}"
                         f" in one step: their trips cannot be extrapolated "
                         f"together")
    (length,) = rec.loop_lengths
    a, b = rec.cost, _measure(fn, args, TRACE_TRIPS + 1).cost
    steps = length - TRACE_TRIPS
    return StepCost(**{k: _extrapolate(getattr(a, k), getattr(b, k), steps)
                       for k in a.__dataclass_fields__})
