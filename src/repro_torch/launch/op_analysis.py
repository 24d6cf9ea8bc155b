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
  * The memory record is that of the step run plainly on the card. A
    recorder is itself a dispatch mode, and a meta tensor is
    "subclass-like" too (``at::isTensorSubclassLike``): either way
    autograd takes the composite-compliant, out-of-place branch where a
    plain eager run writes in place. Three such branches reach the zoo's
    steps: the engine's gradient accumulation (``old + var`` for
    ``old.add_(var)``), ``gather``'s backward
    (``scatter_add`` for ``scatter_add_``) and advanced indexing's
    (``index_put`` for ``_index_put_impl_``). Where the plain run would
    write into an operand (dense, whole storage, the last reference: it
    is freed before the next op), the output takes over that operand's
    bytes, as it would on the card. Counts are not touched: the op is
    charged as dispatched.
  * Trip counts: a long sequential loop (the sLSTM's steps,
    ``models/xlstm.py``) asks :func:`loop_trips` how many steps to run and
    iterates them through :func:`loop_steps`. On real tensors it runs
    them all. On ``meta`` under :func:`analyze` it runs ``n`` and then
    ``n + 1`` (the outputs padded to the full length either way), and
    every count is extrapolated to the full length: each step's forward
    and backward ops are the same, so the counts are affine in the steps
    run, and the extrapolation equals a full trace to the integer. The
    peak is not affine (it moves between phases), so the live-bytes
    curve is extrapolated instead: each storage event is tagged with the
    loop step it runs in (``loop_steps`` marks the forward's steps, and a
    backward op is tagged by the step whose autograd node it runs), the
    ``n + 1`` trace's one extra middle step is repeated where it runs,
    and the padding's per-step events (the zero gradients of the steps not
    run) are dropped; the peak of that curve equals a full trace's to the
    byte.
"""
from __future__ import annotations

import bisect
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch._prims_common import is_non_overlapping_and_dense_or_false
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
    caps a meta trace's loops (:func:`loop_trips`) and tags its memory
    events by loop step (:func:`loop_steps`); :func:`analyze`
    extrapolates."""

    def __init__(self, *, max_trips: int = 0):
        super().__init__()
        self.cost = StepCost()
        self.max_trips = max_trips
        self.loop_lengths = set()       # full lengths of the loops capped
        self._args = set()
        self._arg_bytes = 0
        self._storages = {}             # storage key -> bytes (live)
        #: the live-bytes curve: [bytes, tag] per storage made (+) or
        #: freed (-); an event a plain run does not make reads 0
        self.events = []
        #: an in-place twin not yet settled: [its output's event, the
        #: operand's storage key, the operand's free event, the op]
        self._pending = None
        #: the out-of-place twins reckoned in place, by op
        self.in_place = {}
        #: loop steps (capped traces only): the steps each loop ran, the
        #: step the forward is in, and the autograd sequence numbers each
        #: step's nodes took (starts, and (end, tag) alike)
        self.steps_run = []
        self._trip = None
        self._span_starts = []
        self._spans = []
        self._mark = None

    # -- memory ------------------------------------------------------------
    def _tag(self):
        """The loop step an event runs in: the forward's (``loop_steps``),
        else the step whose autograd node is running; None outside."""
        if self._trip is not None or not self._spans:
            return self._trip
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._span_starts, seq) - 1
        if i >= 0 and (self._spans[i][0] is None or seq < self._spans[i][0]):
            return self._spans[i][1]
        return None

    def _hold(self, t: torch.Tensor) -> Optional[int]:
        """Track ``t``'s storage from now until it is freed; returns its
        key (None if it was tracked already)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return None
        n = st.nbytes()
        self._storages[key] = n
        self.events.append([n, self._tag() if self.max_trips else None])
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key) -> None:
        n = self._storages.pop(key, None)
        if n is None or self.cost.memory:
            return
        if self._pending is not None and key == self._pending[1]:
            self._pending[2] = len(self.events)
        self.events.append([-n, self._tag() if self.max_trips else None])

    def _settle(self) -> None:
        """An in-place twin's output takes over its operand if the operand
        was freed since it ran (the last reference: the plain run wrote
        into it): neither the output's bytes nor the operand's free are
        events."""
        if self._pending is None:
            return
        out_event, _, freed, op = self._pending
        self._pending = None
        if freed is not None:
            self.events[out_event][0] = 0
            self.events[freed][0] = 0
            self.in_place[op] = self.in_place.get(op, 0) + 1

    def _twin(self, func, args, kwargs, out, held: list) -> None:
        """If ``func`` is an out-of-place twin of what a plain run writes
        in place (the module's memory convention), note the operand it
        would write into, to settle at the next op. ``held`` is
        :meth:`_hold`'s answer for each output: a new storage's key, the
        last event made."""
        if torch.is_grad_enabled() or not isinstance(out, torch.Tensor) \
                or held[0] is None:
            return
        node = torch._C._current_autograd_node()
        if node is None:
            return
        if func is _aten.add.Tensor:
            # the engine's InputBuffer::accumulate: old + var, which a
            # plain run writes into old (never into var)
            if len(args) != 2 or kwargs.get("alpha", 1) != 1:
                return
        elif not ((func is _aten.scatter_add.default
                   and node.name() == "GatherBackward0") or (
                func is _aten.index_put.default
                and node.name() == "IndexBackward0")):
            return
        t = args[0]
        if not (isinstance(t, torch.Tensor) and t.shape == out.shape
                and t.dtype == out.dtype and not t._is_view()
                and is_non_overlapping_and_dense_or_false(t)):
            return
        key = t.untyped_storage()._cdata
        if self._storages.get(key) == self._storages[held[0]]:
            self._pending = [len(self.events) - 1, key, None,
                             func.overloadpacket.__name__]

    def add_arguments(self, args) -> None:
        """The step's inputs: live throughout, ``argument_size``."""
        for t in _tensors(args):
            key = self._hold(t)
            if key is not None:
                self._args.add(key)
                self._arg_bytes += self._storages[key]

    def close(self, out) -> StepCost:
        """The memory record of a step that returned ``out``."""
        self._settle()
        self.events = [tuple(e) for e in self.events if e[0]]
        outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(out)}
        self.cost.memory = {
            "argument_size": self._arg_bytes,
            "output_size": sum(n for k, n in outs.items()
                               if k not in self._args),
            "temp_size": _peak(self.events) - self._arg_bytes,
            "generated_code_size": None}
        return self.cost

    # -- loop steps (capped traces) -----------------------------------------
    def _seq(self) -> Optional[int]:
        """The autograd sequence number the next node takes (a view of a
        marker leaf, made with this mode off)."""
        if not torch.is_grad_enabled():
            return None
        with torch._C._DisableTorchDispatch():
            if self._mark is None:
                self._mark = torch.empty((), device="meta",
                                         requires_grad=True)
            return self._mark.view(()).grad_fn._sequence_nr() + 1

    def _end_span(self) -> None:
        if self._trip is not None and self._spans:
            seq = self._seq()
            if seq is not None and self._spans[-1][0] is None:
                self._spans[-1] = (seq, self._spans[-1][1])

    def enter_step(self, t: int) -> None:
        self._end_span()
        if t == 0:
            self.steps_run.append(0)
        tag = (len(self.steps_run) - 1, t)
        self.steps_run[-1] = t + 1
        self._trip = tag
        seq = self._seq()
        if seq is not None:
            self._span_starts.append(seq)
            self._spans.append((None, tag))

    def exit_loop(self) -> None:
        self._end_span()
        self._trip = None

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
        self._settle()
        out = func(*args, **kwargs)
        if func.namespace in _UNCHARGED:
            return out
        self.cost.ops += 1
        self._charge(func, args, kwargs, out)
        held = [self._hold(t) for t in _tensors(out)]
        self._twin(func, args, kwargs, out, held)
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


def loop_steps(steps):
    """Iterate a sequential loop's ``steps`` (the :func:`loop_trips` it
    runs): a capped recorder tags the memory events of each step, forward
    and backward, with the step (:func:`analyze`)."""
    recs = [r for r in _recorders() if r.max_trips]
    if not recs:
        yield from steps
        return
    try:
        for t, step in enumerate(steps):
            for rec in recs:
                rec.enter_step(t)
            yield step
    finally:
        for rec in recs:
            rec.exit_loop()


def _peak(events) -> int:
    live = peak = 0
    for d, _ in events:
        live += d
        peak = max(peak, live)
    return peak


def _measure(fn, args, max_trips: int) -> OpCost:
    rec = OpCost(max_trips=max_trips)
    with rec:
        rec.add_arguments(args)
        rec.close(fn(*args))
    return rec


def measure(fn, *args) -> StepCost:
    """The counts of one full run of ``fn(*args)``: no loop capped."""
    return _measure(fn, args, 0).cost


#: the steps a capped meta trace runs (and one more): enough that its
#: middle steps are apart from the ends' (see :func:`_aligned`)
TRACE_TRIPS = 4

#: the step of the ``n + 1`` trace that a full run repeats
_MIDDLE = 2


def _extrapolate(a, b, steps: int):
    """``a`` at n trips, ``b`` at n + 1: the value at n + ``steps``."""
    if isinstance(a, dict):
        return {k: _extrapolate(a.get(k, 0), b.get(k, 0), steps)
                for k in set(a) | set(b)}
    if a is None:
        return None
    return a + steps * (b - a)


def _period(x, p: int, y, q: int) -> int:
    """The shortest m (at most ``_MAX_PERIOD``) such that ``x[p:p+m]``
    repeats the m events before it and ``x[p+m]`` is ``y[q]``: an extra
    copy in a run of ``x`` that ``y`` has one fewer of; 0 if none."""
    for m in range(1, min(_MAX_PERIOD, p) + 1):
        if p + m > len(x) or x[p:p + m] != x[p - m:p]:
            continue
        if (x[p + m] == y[q]) if p + m < len(x) and q < len(y) else (
                p + m == len(x) and q == len(y)):
            return m
    return 0


#: the longest block of events that repeats once a loop step in a run
#: outside the steps (the padding's zero gradients, the steps' gradient
#: frees)
_MAX_PERIOD = 64


def _aligned(a: OpCost, b: OpCost):
    """``b``'s events (one more step a loop than ``a``) against ``a``'s.
    A loop's steps are alike but at its ends: step 0 (its state needs no
    gradient), step 1 (the storages all steps share are freed in its
    backward), the step before the last (its backward makes the first sum
    of the shared weights' gradients) and the last (the padding's). So in
    a loop where ``a`` ran k >= 4 steps and ``b`` k + 1, ``b``'s step
    ``_MIDDLE`` is the inserted one and its later steps are ``a``'s, one
    down. Every other event of ``b`` is one of ``a``'s, in order, but for
    the runs outside the steps whose length goes with the steps run: a
    run ``b`` has one more copy of (the real steps' gradients, freed
    together) or one fewer (the padding's zero gradients). Returns the
    blocks ``b`` inserts, by the index of ``a``'s event they precede, and
    ``a``'s blocks ``b`` lacks, as (start, length)."""
    if len(a.steps_run) != len(b.steps_run):
        raise ValueError(f"{len(a.steps_run)} against {len(b.steps_run)} "
                         f"loops: the traces do not align")
    ev, rest, step_ins = a.events, [], {}
    for d, tag in b.events:
        if tag is not None:
            j, t = tag
            if b.steps_run[j] == a.steps_run[j] + 1 and t >= _MIDDLE:
                if t == _MIDDLE:
                    blocks = step_ins.setdefault(len(rest), [])
                    if not blocks or blocks[-1][0] != j:
                        blocks.append((j, []))
                    blocks[-1][1].append(d)
                    continue
                tag = (j, t - 1)
        rest.append((d, tag))
    ins, lacks, i, j = {}, [], 0, 0
    while j <= len(rest):
        if j in step_ins:
            ins.setdefault(i, []).extend(step_ins.pop(j))
        if j == len(rest):
            break
        if i < len(ev) and ev[i] == rest[j]:
            i, j = i + 1, j + 1
            continue
        m = _period(rest, j, ev, i)
        if m:
            ins.setdefault(i, []).append((None, [d for d, _ in
                                                rest[j:j + m]]))
            j += m
            continue
        m = _period(ev, i, rest, j)
        if not m:
            raise ValueError(f"event {j} of the n + 1 trace, {rest[j]}, is "
                             f"neither the n trace's {ev[i:i + 1]} nor one "
                             f"more or one fewer in a run: the traces do "
                             f"not align")
        lacks.append((i, m))
        i += m
    if i != len(ev):
        raise ValueError(f"the n trace's events {i}.. are not in the n + 1 "
                         f"trace: the traces do not align")
    return ins, lacks


def _extrapolated_peak(a: OpCost, b: OpCost, steps: int) -> int:
    """The peak of the live-bytes curve at ``steps`` more steps a loop
    than ``a`` ran (``b`` ran one more): ``b``'s inserted blocks repeat
    ``steps`` times where they ran (each copy's peak is its first's or its
    last's), and each block ``a`` has one more of than ``b`` loses
    ``steps`` copies of its run."""
    if steps <= 0:
        return _peak(a.events)
    ins, lacks = _aligned(a, b)
    ev = a.events
    drop = [False] * len(ev)
    for i, m in lacks:
        lo = i - (steps - 1) * m
        if lo < 0 or any(ev[lo + c] != ev[i + c % m] for c in range(i - lo)) \
                or any(ins.get(k) for k in range(lo + 1, i + m)):
            raise ValueError(f"events {i}..{i + m} of the n trace repeat "
                             f"fewer than {steps} times: the run does not "
                             f"extrapolate")
        for c in range(lo, i + m):
            drop[c] = True
    live = peak = 0
    for idx in range(len(ev) + 1):
        for _, block in ins.get(idx, ()):
            net = top = 0
            for d in block:
                net += d
                top = max(top, net)
            peak = max(peak, live + top, live + (steps - 1) * net + top)
            live += steps * net
        if idx < len(ev) and not drop[idx]:
            live += ev[idx][0]
            peak = max(peak, live)
    return peak


def analyze(fn, *args) -> StepCost:
    """The counts of ``fn(*args)``. On ``meta`` inputs a long sequential
    loop is traced at ``TRACE_TRIPS`` and ``TRACE_TRIPS + 1`` steps, every
    count extrapolated to its full length and the memory record from the
    extrapolated live-bytes curve (the module's trip-count convention);
    otherwise one full run."""
    meta = any(t.is_meta for t in _tensors(args))
    rec = _measure(fn, args, TRACE_TRIPS if meta else 0)
    if not rec.loop_lengths:
        return rec.cost
    if len(rec.loop_lengths) > 1:
        raise ValueError(f"loops of several lengths {sorted(rec.loop_lengths)}"
                         f" in one step: their trips cannot be extrapolated "
                         f"together")
    (length,) = rec.loop_lengths
    a, b = rec.cost, _measure(fn, args, TRACE_TRIPS + 1)
    steps = length - TRACE_TRIPS
    out = StepCost(**{k: _extrapolate(getattr(a, k), getattr(b.cost, k),
                                      steps)
                      for k in a.__dataclass_fields__ if k != "memory"})
    out.memory = dict(a.memory, temp_size=_extrapolated_peak(rec, b, steps)
                      - a.memory["argument_size"])
    return out
