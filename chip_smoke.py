"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
then, on the card:

1. holds each kernel against its plain PyTorch twin at the shapes of the
   FedCAMS round on ConvMixer-256-8 (d = 704,266, blocks of 2048, k = 32,
   n = 10 clients of m = 100): ``topk_ef_sparse`` and ``topk_ef`` at
   k = 32, k = 1 and on a tie-laden input, at k = 1024 and k = block (more
   picks than a CTA has threads), and on ``ref.topk_hard_cases`` (values
   equal but for the last radix digit, all-equal magnitudes, more ties at
   the threshold than are kept, NaNs beside ±inf, ±0.0 and denormals) at
   blocks of 128, 384 and 2048 and k in {1, 2, 31, 32, 33, 1024, block},
   with ``torch.topk`` on the same blocks timed as the nearest library
   call; ``sign_ef`` with zeros, -0.0 and a NaN client, at c = 1 and
   c = 12 (more blocks than the card holds on chip), at d = 2047, 2048 and
   2049, three calls back to back and one on a second stream (one launch
   each), and at a d past 2^24 (its scale tree runs in chunks);
   ``pack_uint``/``unpack_uint`` over the (c, ·) message block of a round,
   one launch a call: the sign codec's fused pair (the ``>= 0`` predicate
   packed from the (10, 704,266) fp32 totals into 88,054-byte messages at
   column 20, and the scaled unpack that reads each row's scale from the
   message), on totals with -0.0, NaNs, ±inf and denormals and scales of
   NaN, ±inf, ±0 and a denormal, and with per-block scales; blocktopk's
   11-bit offsets (10 × 11,008) into 59,184-byte messages at column 16;
   every n in 1..32 at c = 1, 3 and 10 with odd row strides and offsets
   that put the streams at every alignment mod 16 (uint8 values too where
   n <= 8); and one-row calls with their round trip;
   ``fedams_ingest`` at fp32, bf16 and int8 state for both options and with
   a NaN delta, and on ``ref.INGEST_HARD_CASES`` (d = block - 1, block,
   block + 1 and every d mod 4 near the main path's; blocks of 128, 384,
   2048 and 4096; n = 1 and 64; k = 1, 33 and block; every client on the
   same coordinates with values that only a client-major sum gets right;
   an int8 block of zeros; state at an odd offset) at each dtype and
   option, its time and bound at each dtype, and on route j's partial
   flush (B = 5 rows, pre-scaled by staleness weights: two empty slots of
   k copies of index 0 and +0.0, one rejected row with a flipped index
   and zeroed values); ``fedams_update`` for both
   options at a ragged N, also with NaN deltas. All bitwise (a NaN must
   meet a NaN). Each kernel is timed with CUDA events (median of 30
   launches, L2 flushed before each) beside its twin and its bound;
2. checks the round on the card against the same round on the CPU (the
   port's twins, which the CPU tests hold against the JAX package) on a
   small MLP problem, every route below (route g through the trainer, j
   through the async engine, l on randk positions drawn on the host), with
   the fault verdicts of routes h and i and j's flushes equal;
3. runs the FedCAMS round on ConvMixer-256-8 (random weights from a seed,
   synthetic CIFAR-shaped data), 6 rounds on each route:
   (a) blocktopk, ``track_gamma=False``, fused ingest → ``topk_ef_sparse``
       + ``fedams_ingest``;
   (b) blocktopk, ``track_gamma=True`` → ``topk_ef_sparse``, scatter-mean
       + ``fedams_update``;
   (c) sign, in memory → ``sign_ef`` + ``fedams_update``;
   (d) sign over the packed wire →
       ``pack_uint``/``unpack_uint`` (n = 1) + ``fedams_update``;
   (e) blocktopk 1/64 over the dense uplink (``sparse_uplink=False``) →
       ``topk_ef`` + ``fedams_update``;
   (f) as (e) over the packed wire → ``pack_uint``/``unpack_uint``
       (n = 11) + ``fedams_update``;
   (g) ``examples/quickstart_wire.py``'s configuration through
       ``FederatedTrainer.run``: sign over the wire with the two-way
       compressed downlink and its network (10/50 Mbit/s, 5 % stragglers),
       ``checkpoint_every=3``, then ``trainer.save`` and ``load_pytree`` →
       ``pack_uint``/``unpack_uint`` twice a round (the uplink block and
       the downlink message) + ``fedams_update``; the restored state
       equals the trainer's to the bit;
   (h) blocktopk 1/64 over the wire, ``track_gamma=False``, with crashes
       (p = 0.1), bit flips (p = 0.2) and a round deadline → the survivor-
       masked two-pass server: ``topk_ef_sparse`` + ``fedams_update``,
       ``fedams_ingest`` never; the deadline (the 85th percentile of the
       cohorts' simulated client times) and the fault seed (the first
       whose plans hold a crash, a rejection and a cut in the 6 rounds)
       are chosen on the host before the round and printed;
   (i) sign in memory with a scheduled crash of round 0's first client
       (rounds 0-2), NaN payloads (p = 0.3) and a norm clip at the median
       norm of a probe round's payloads → ``sign_ef`` + ``fedams_update``;
       the share of payloads clipped is printed.
   (j) blocktopk 1/64 over the wire, ``track_gamma=False``, the async
       buffered engine (``async_buffer=5``, ``inv_sqrt`` staleness) over
       wire_network's links, 6 cohorts → ``topk_ef_sparse`` once a cohort,
       ``fedams_ingest`` once a flush (⌈60 / 5⌉ = 12, the straggler share
       raised from 0.05 until a flush ingests stale work); the flushes'
       staleness and weight sums are printed. Then ``async_buffer=10``,
       ``uniform``, 3 cohorts under deterministic algorithms, held equal
       to 3 sync rounds of the same configuration to the bit (params, m,
       v, v-hat, EF rows);
   (k) blocktopk 1/64 over the wire, ``track_gamma=False``, m = 1,000
       with the host-side EF store (``ef_store``), ``client_chunk=5`` and
       ``agg_groups=2`` → ``topk_ef_sparse`` twice a round, ``fedams_update``
       once, ``fedams_ingest`` never; the device holds a (10, d) EF block,
       the store's materialized bytes and the tier-2 bytes are printed.
       Under deterministic algorithms 3 rounds equal the resident (1,000,
       d) buffer's to the bit: params and every client's EF row;
   (l) randk 1/64 in memory, γ on (the default), ``client_chunk=5`` →
       ``fedams_update`` once a round; each round's drawn sets hold k
       distinct positions.
   On h and i every round has survivors + rejected + crashed +
   deadline_cut = n, the EF rows of the clients the server did not ingest
   equal their pre-round rows to the bit, and the state stays finite.
   Every kernel launch counter is reset before a route and read after it;
   a route whose kernels never launched fails. Each route's final params,
   EF buffer and server state are hashed (``state_sha256``); route a runs
   3 more rounds with deterministic algorithms, whose final state two
   builds can be held equal on to the bit (local training on the card is
   not bit-reproducible otherwise). Wire routes also check that
   ``pack_uint`` and ``unpack_uint`` launched once a round for all n
   clients, that every encoded message is ``codec.nbytes(d)`` long and
   that each round bills n of them uplink.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Exits nonzero, with no result,
without CUDA or when any check fails. Longer output goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS needs this before CUDA starts for deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3 (data sheet)
PEAK_F32_S = 67e12       # H100 SXM fp32 outside the tensor cores
REPLACES = {
    "topk_ef_sparse": "src/repro/kernels/topk_ef.py:90",
    "fedams_ingest": "src/repro/kernels/fedams_ingest.py:127",
    "fedams_update": "src/repro/kernels/fedams_update.py:55",
    "topk_ef": "src/repro/kernels/topk_ef.py:69",
    "sign_ef": "src/repro/kernels/sign_ef.py:38",
    "pack_uint": "src/repro/kernels/bitpack.py:184",
    "unpack_uint": "src/repro/kernels/bitpack.py:210",
}
ROUTES = ("a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l")
EXPECT = {"a": ("topk_ef_sparse", "fedams_ingest"),
          "b": ("topk_ef_sparse", "fedams_update"),
          "c": ("sign_ef", "fedams_update"),
          "d": ("pack_uint", "unpack_uint", "fedams_update"),
          "e": ("topk_ef", "fedams_update"),
          "f": ("pack_uint", "unpack_uint", "fedams_update"),
          "g": ("pack_uint", "unpack_uint", "fedams_update"),
          "h": ("topk_ef_sparse", "fedams_update"),
          "i": ("sign_ef", "fedams_update"),
          "j": ("topk_ef_sparse", "fedams_ingest"),
          "k": ("topk_ef_sparse", "fedams_update"),
          "l": ("fedams_update",)}
#: the fault models of routes h and i (the deadline, seed, crashed client
#: and clip norm are chosen per run: h_fault, i_fault)
FAULT_H = dict(crash_prob=0.1, corrupt_prob=0.2, corrupt_mode="bitflip")
FAULT_I = dict(corrupt_prob=0.3, corrupt_mode="nan")
VERDICTS = ("survivors", "rejected", "crashed", "deadline_cut")

# the slice: ConvMixer-256-8, fedcams + blocktopk 1/64, m=100, n=10, K=3, B=20
M, N_CLI, K_STEPS, BATCH, RATIO, BLOCK = 100, 10, 3, 20, 1 / 64, 2048
M_K = 1000      # route k's client count (its EF rows live in the host store)
ROUNDS = 6      # rounds (cohorts on route j) a route runs in phase 3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, before=None, iters: int = 30, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times. ``before`` runs outside the
    timed window (restoring inputs, flushing L2). A spin kernel ahead of
    the start event keeps the card busy while the host enqueues ``fn``, so
    the window holds device time and not the wrapper's host overhead. The
    NaN fill that deterministic mode gives ``torch.empty`` (which lets the
    checks catch an output a kernel leaves unwritten) is off while timing:
    the window holds the kernel, not a fill of its outputs."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for _ in range(warmup):
            if before:
                before()
            fn()
        times = []
        for _ in range(iters):
            if before:
                before()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
    return float(np.median(times))


def bound(nbytes: int, flops: int):
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs(a, b) -> float:
    """Largest |a - b| over the positions where both are numbers."""
    diff = (a.double() - b.double()).abs()
    diff = diff[~diff.isnan()]
    return float(diff.max()) if diff.numel() else 0.0


def same(name, got, want):
    """Bitwise equal outputs; a NaN must meet a NaN (its payload is not
    compared)."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: output {i} is {g.dtype}{tuple(g.shape)}, twin "
              f"{w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            gn, wn = g.isnan(), w.isnan()
            if not torch.equal(gn, wn):
                bad.append(f"output {i}: NaN at {int((gn != wn).sum())} "
                           f"positions of one side only")
                continue
            g, w = g[~gn], w[~wn]
        if not torch.equal(g, w):
            bad.append(f"output {i}: {int((g != w).sum())} of {g.numel()} "
                       f"differ, max abs {max_abs(g.float(), w.float())}")
    check(not bad, f"{name} differs from the twin: {'; '.join(bad)}")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its twin at the slice's shapes
# ---------------------------------------------------------------------------


def phase_kernels(dev, d: int):
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(0)
    nb = -(-d // BLOCK)
    k = max(1, int(round(RATIO * BLOCK)))
    rows = torch.randperm(M, generator=g, device=dev)[:N_CLI].contiguous()
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)
    out = {}
    x = torch.randn(N_CLI, d, generator=g, device=dev) * 0.01
    err0 = torch.randn(M, d, generator=g, device=dev) * 0.003
    ties_x = (torch.randint(-2, 3, (N_CLI, d), generator=g, device=dev)
              .float() * 0.5)
    zeros = torch.zeros_like(err0)
    err = err0.clone()

    def evict():
        flush.sum()       # read 256 MB: L2 holds clean lines of nothing used

    def restore():
        err.copy_(err0)
        evict()

    def worst_of(got, want):
        return max(max_abs(a.float(), b.float())
                   for a, b in zip(got, want) if a.is_floating_point())

    # -- topk_ef_sparse, topk_ef: one selection, compacted or dense ----------
    cases = [(x, err0, k, BLOCK, "k=32"), (x, err0, 1, BLOCK, "k=1"),
             (ties_x, zeros, k, BLOCK, "ties"),
             (ties_x, zeros, 1, BLOCK, "ties k=1"),
             # more picks than the CTA has threads
             (x, err0, 1024, BLOCK, "k=1024"),
             (ties_x, zeros, BLOCK, BLOCK, "ties k=block")]
    # inputs that trip a threshold select (ref.topk_hard_cases), with an EF
    # of -0.0, which adds nothing to any value
    hard = ref.topk_hard_cases(N_CLI, d, seed=1).to(dev)
    negz = torch.full_like(err0, -0.0)
    cases += [(hard, negz, kk, blk, f"hard cases, block={blk}, k={kk}")
              for blk in (128, 384, BLOCK)
              for kk in (1, 2, 31, 32, 33, 1024, blk) if kk <= blk]
    topk = {
        "topk_ef_sparse": (ops.topk_ef_sparse_cuda, ref.topk_ef_sparse, list,
                           N_CLI * d * 4 * 3 + N_CLI * nb * k * 8 + N_CLI * 8,
                           N_CLI * d),
        "topk_ef": (ops.topk_ef_cuda, ref.topk_ef, lambda hat: [hat],
                    N_CLI * d * 4 * 4 + N_CLI * 8, N_CLI * d * 2),
    }
    for name, (kern, twin, outs, nbytes, flops) in topk.items():
        worst = 0.0
        for xin, e_in, kk, blk, what in cases:
            e_k, e_r = e_in.clone(), e_in.clone()
            got = outs(kern(xin, e_k, rows, k=kk, block=blk)) + [e_k]
            want = outs(twin(xin, e_r, rows, k=kk, block=blk)) + [e_r]
            torch.cuda.synchronize()
            same(f"{name}[{what}]", got, want)
            worst = max(worst, worst_of(got, want))
        # the kernel without the wrapper's rows check, which syncs the host
        ms = time_ms(lambda: kern(x, err, rows, k=k, block=BLOCK,
                                  check_rows=False), restore)
        plain = time_ms(lambda: twin(x, err, rows, k=k, block=BLOCK),
                        restore, iters=10)
        out[name] = dict(
            ms=ms, plain_ms=plain, max_abs_err=worst, bytes=nbytes,
            flops=flops, library_ms=None, cases=len(cases),
            shapes=f"x ({N_CLI},{d}) f32, err ({M},{d}) f32, k={k}, "
                   f"block={BLOCK}")
    # the nearest library call: torch.topk of the same |tot| blocks, which
    # neither breaks ties to the lowest index nor writes EF (so not
    # library_ms); and the digit passes the selection takes on these blocks
    tb = F.pad(x + err0[rows], (0, nb * BLOCK - d)).view(N_CLI * nb, BLOCK)
    mag = tb.abs()
    topk_ms = time_ms(lambda: torch.topk(mag, k, dim=-1), evict)
    passes = torch.bincount(ref.threshold_select(tb, k)[2], minlength=5)
    for name in topk:
        out[name].update(nearest_library="torch.topk",
                         nearest_library_ms=topk_ms,
                         select_passes=passes.tolist()[1:])
    del tb, mag, hard, negz

    # -- sign_ef -------------------------------------------------------------
    worst = 0.0

    def sign_case(what, xin, e_in, r_in):
        """One call, bitwise against the twin, one launch; returns the
        kernel's hat and EF buffer."""
        nonlocal worst
        e_k, e_r = e_in.clone(), e_in.clone()
        n0 = ops.launches["sign_ef"]
        got = [ops.sign_ef_cuda(xin, e_k, r_in), e_k]
        check(ops.launches["sign_ef"] == n0 + 1,
              f"sign_ef[{what}]: {ops.launches['sign_ef'] - n0} launches")
        want = [ref.sign_ef(xin, e_r, r_in), e_r]
        torch.cuda.synchronize()
        same(f"sign_ef[{what}]", got, want)
        worst = max(worst, worst_of(got, want))
        return got

    xs = x.clone()
    xs[0, ::5] = 0.0
    xs[0, 1::5] = -0.0
    es = err0.clone()
    es[rows[0], ::5] = 0.0
    es[rows[0], 1::5] = -0.0     # -0.0 + -0.0 = -0.0: sign(-0.0) = +1
    bad = N_CLI // 2
    xs[bad, d // 2] = float("nan")  # a diverged client: its hat is all NaN
    got = sign_case("zeros, -0.0, NaN client", xs, es, rows)
    check(bool(got[0][bad].isnan().all()) and not bool(
        got[0][torch.arange(N_CLI, device=dev) != bad].isnan().any()),
        "sign_ef: the NaN client's hat is not all NaN, or another is")
    check(bool((got[0][0][::5] > 0).all()), "sign_ef: sign(0) is not +1")
    # one client; 12 clients, more blocks than the card holds on chip (some
    # are read twice); widths around one block
    sign_case("c=1", xs[:1], es, rows[:1])
    x12 = torch.randn(12, d, generator=g, device=dev) * 0.01
    r12 = torch.randperm(M, generator=g, device=dev)[:12].contiguous()
    sign_case("c=12, blocks read again", x12, err0, r12)
    del x12
    for dd in (2047, 2048, 2049):
        sign_case(f"d={dd}", xs[:, :dd].contiguous(),
                  es[:, :dd].contiguous(), rows)
    # back to back on one stream with no sync (the arrival counts start
    # over on every call), then on a second stream
    e_k, e_r = es.clone(), es.clone()
    n0 = ops.launches["sign_ef"]
    got = [ops.sign_ef_cuda(xs * (i + 1), e_k, rows) for i in range(3)]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got.append(ops.sign_ef_cuda(xs, e_k, rows))
    torch.cuda.current_stream(dev).wait_stream(side)
    want = [ref.sign_ef(xs * (i + 1), e_r, rows) for i in range(3)]
    want.append(ref.sign_ef(xs, e_r, rows))
    torch.cuda.synchronize()
    check(ops.launches["sign_ef"] == n0 + 4,
          f"sign_ef: {ops.launches['sign_ef'] - n0} launches for 4 calls")
    same("sign_ef[3 calls back to back, then a second stream]",
         got + [e_k], want + [e_r])
    worst = max(worst, worst_of(got + [e_k], want + [e_r]))
    del xs, es, e_k, e_r, got, want
    # more partials per client than one tree takes: the scale sums in chunks
    dl = ref.SIGN_BLOCK * (ref.SIGN_CHUNK + 3) + 7
    xl = torch.randn(2, dl, generator=g, device=dev)
    el = torch.randn(3, dl, generator=g, device=dev) * 0.1
    sign_case(f"d={dl}, chunked scale", xl, el,
              torch.tensor([2, 0], device=dev))
    del xl, el
    ms = time_ms(lambda: ops.sign_ef_cuda(x, err, rows, check_rows=False),
                 restore)
    plain = time_ms(lambda: ref.sign_ef(x, err, rows), restore, iters=10)
    out["sign_ef"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=worst,
        bytes=N_CLI * d * 4 * 4 + N_CLI * 8, flops=N_CLI * d * 5,
        library_ms=None,
        shapes=f"x ({N_CLI},{d}) f32, err ({M},{d}) f32, {nb} partials "
               f"per client")
    del ties_x, zeros

    # -- fedams_ingest -------------------------------------------------------
    tot = torch.randn(N_CLI, d, generator=g, device=dev)
    vals, idx = ref.topk_ef_sparse(tot, torch.zeros(N_CLI, d, device=dev),
                                   torch.arange(N_CLI, device=dev), k=k,
                                   block=BLOCK)
    vals = vals * 0.01
    xs = torch.randn(d, generator=g, device=dev)
    ms_ = torch.randn(d, generator=g, device=dev) * 1e-3
    v32 = torch.rand(d, generator=g, device=dev) * 1e-4
    vh32 = v32 + torch.rand(d, generator=g, device=dev) * 1e-4
    kw = dict(n_div=N_CLI, eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4,
              block=BLOCK)
    # route j's partial flush of B = 5 slots, pre-scaled as
    # FedSim._async_flush scales them (w·B/max(Σw, 1); w = inv_sqrt of τ = 0
    # and 1 on the two live slots): slot 2 rejected (the bit-flip fault
    # knocks entry 0's index out of the domain; validation zeroes its
    # values), slots 3 and 4 empty as the engine leaves them — k copies of
    # index 0 in block 0 with +0.0, which the kernel's lanes add at once
    bp = 5
    w = torch.tensor([1.0, float(np.float32(1 / np.sqrt(2.0))), 0.0, 0.0,
                      0.0], device=dev)
    scale = w * (torch.full((), bp, dtype=torch.float32, device=dev)
                 / w.sum().clamp_min(1.0))
    partial = (torch.where(w[:, None, None] > 0, vals[:bp], 0.0)
               * scale[:, None, None], idx[:bp].clone())
    partial[1][2].view(-1)[0] ^= 1 << 29
    partial[1][3:] = 0
    worst = 0.0
    timed = {}
    for sd in ("float32", "bfloat16", "int8"):
        if sd == "int8":
            q = torch.randint(0, 128, (nb * BLOCK,), generator=g, device=dev,
                              dtype=torch.int8)
            qh = torch.randint(0, 128, (nb * BLOCK,), generator=g,
                               device=dev, dtype=torch.int8)
            sc = torch.rand(nb, generator=g, device=dev) * 1e-6 + 1e-7
            args = (xs, ms_, q, qh, vals, idx, sc, sc * 1.5)
            sbytes = 2 * (nb * BLOCK + nb * 4)
        else:
            dt = getattr(torch, sd)
            args = (xs, ms_, v32.to(dt), vh32.to(dt), vals, idx)
            sbytes = 2 * d * (4 if sd == "float32" else 2)
        # a diverged client: NaN must reach v-hat (and int8 scales) as in
        # the twin and the JAX reference
        nan_args = list(args)
        nan_args[4] = vals.clone()
        nan_args[4][3, 7, :5] = float("nan")
        for option, a, what in ((1, args, ""), (2, args, ""),
                                (1, nan_args, ", NaN delta")):
            got = ops.fedams_ingest_cuda(*a, option=option,
                                         state_dtype=sd, **kw)
            want = ref.fedams_ingest_ref(*a, option=option,
                                         state_dtype=sd, **kw)
            torch.cuda.synchronize()
            same(f"fedams_ingest[{sd}, option {option}{what}]", got, want)
            vhat = got[5] if sd == "int8" else got[3]
            check(bool(vhat.float().isnan().any()) == bool(what),
                  f"fedams_ingest[{sd}{what}]: NaN in v-hat is "
                  f"{bool(vhat.float().isnan().any())}")
            worst = max(worst, max(max_abs(a.float(), b.float())
                                   for a, b in zip(got, want)))
        # the hard cases: ragged d, every d mod 4, blocks of 128 to 4096,
        # n = 1 and 64, k = 1, 33 and block, all clients on the same
        # coordinates, an int8 block of zeros, state at an odd offset
        for name, hd, hblock, hn, hk, kind in ref.INGEST_HARD_CASES:
            ha = ref.ingest_case(hd, hblock, hn, hk, sd, kind, device=dev)
            for option in (1, 2):
                hkw = dict(kw, n_div=hn, block=hblock, option=option,
                           state_dtype=sd)
                got = ops.fedams_ingest_cuda(*ha, **hkw)
                want = ref.fedams_ingest_ref(*ha, **hkw)
                torch.cuda.synchronize()
                same(f"fedams_ingest[{sd}, option {option}, {name}]", got,
                     want)
                worst = max(worst, max(max_abs(a.float(), b.float())
                                       for a, b in zip(got, want)))
        part_args = list(args)
        part_args[4:6] = partial
        for option in (1, 2):
            pkw = dict(kw, n_div=bp, option=option, state_dtype=sd)
            got = ops.fedams_ingest_cuda(*part_args, **pkw)
            want = ref.fedams_ingest_ref(*part_args, **pkw)
            torch.cuda.synchronize()
            same(f"fedams_ingest[{sd}, option {option}, route j's partial "
                 f"flush]", got, want)
            worst = max(worst, max(max_abs(a.float(), b.float())
                                   for a, b in zip(got, want)))
        timed[sd] = (args, 2 * (2 * d * 4) + 2 * sbytes + vals.numel() * 8)
    ms = {sd: time_ms(lambda a=a: ops.fedams_ingest_cuda(
        *a, option=1, state_dtype=sd, **kw), evict)
        for sd, (a, _) in timed.items()}
    args, nbytes = timed["float32"]
    plain = time_ms(lambda: ref.fedams_ingest_ref(*args, option=1, **kw),
                    evict, iters=10)
    out["fedams_ingest"] = dict(
        ms=ms["float32"], plain_ms=plain, max_abs_err=worst, bytes=nbytes,
        flops=d * 14 + vals.numel(), library_ms=None,
        ms_bf16=ms["bfloat16"], ms_int8=ms["int8"],
        bytes_bf16=timed["bfloat16"][1], bytes_int8=timed["int8"][1],
        bound_ms_by_dtype={sd: b / PEAK_BYTES_S * 1e3
                           for sd, (_, b) in timed.items()},
        cases=3 * (3 + 2 * len(ref.INGEST_HARD_CASES) + 2),
        shapes=f"d={d}, vals/idx ({N_CLI},{nb},{k}), fp32 state "
               f"(bf16/int8 timed too)")

    # -- fedams_update -------------------------------------------------------
    ins = [torch.randn(d, generator=g, device=dev),
           torch.randn(d, generator=g, device=dev) * 1e-3,
           torch.rand(d, generator=g, device=dev) * 1e-4,
           torch.rand(d, generator=g, device=dev) * 2e-4,
           torch.randn(d, generator=g, device=dev) * 1e-2]
    kw = dict(eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4)
    nan_ins = list(ins)
    nan_ins[4] = ins[4].clone()
    nan_ins[4][::4099] = float("nan")      # non-finite deltas
    worst = 0.0
    for option, a, what in ((1, ins, ""), (2, ins, ""),
                            (1, nan_ins, ", NaN delta"),
                            (2, nan_ins, ", NaN delta")):
        got = ops.fedams_update_cuda(*a, option=option, **kw)
        want = ref.fedams_update_ref(*a, option=option, **kw)
        torch.cuda.synchronize()
        same(f"fedams_update[option {option}{what}]", got, want)
        check(bool(got[3].isnan().any()) == bool(what),
              f"fedams_update[option {option}{what}]: NaN in v-hat is "
              f"{bool(got[3].isnan().any())}")
        worst = max(worst, max(max_abs(a, b) for a, b in zip(got, want)))
    ms = time_ms(lambda: ops.fedams_update_cuda(*ins, option=1, **kw), evict)
    plain = time_ms(lambda: ref.fedams_update_ref(*ins, option=1, **kw),
                    evict)
    out["fedams_update"] = dict(
        ms=ms, plain_ms=plain, max_abs_err=worst, bytes=9 * d * 4,
        flops=12 * d, library_ms=None,
        shapes=f"N={d} (ragged), fp32")
    # -- pack_uint / unpack_uint ---------------------------------------------
    worst_p = worst_u = 0.0

    def rows_case(what, vals, nbits, block, col, dtype, scale_block=None):
        """One rows pack and one rows unpack, each one launch, bitwise to
        the twins over the whole block (bytes outside the streams stay)."""
        nonlocal worst_p, worst_u
        count = vals.shape[1]
        fkw = ({} if scale_block is None else
               dict(scale_col=16, scale_block=scale_block))
        n0 = dict(ops.launches)
        got = ops.pack_uint_rows(vals, nbits, block.clone(), col)
        back = ops.unpack_uint_rows(got, col, nbits, count, dtype, **fkw)
        check(ops.launches["pack_uint"] == n0["pack_uint"] + 1 and
              ops.launches["unpack_uint"] == n0["unpack_uint"] + 1,
              f"pack/unpack_uint_rows[{what}]: not one launch a call")
        want = ref.pack_uint_rows(vals, nbits, block.clone(), col)
        back_r = ref.unpack_uint_rows(want, col, nbits, count, dtype, **fkw)
        torch.cuda.synchronize()
        same(f"pack_uint_rows[{what}]", [got], [want])
        check(torch.equal(back.view(torch.int32) if dtype == torch.float32
                          else back,
                          back_r.view(torch.int32) if dtype == torch.float32
                          else back_r),
              f"unpack_uint_rows[{what}] differs from the twin")
        worst_p = max(worst_p, max_abs(got.float(), want.float()))
        worst_u = max(worst_u, max_abs(back.double(), back_r.double()))
        return got

    # the main path's blocks: the sign codec's fused pair over 10 clients
    # of d = 704,266 (messages of 88,054 bytes: row r's stream at 6r + 4 mod
    # 16), totals with -0.0, NaNs, ±inf and denormals, scales NaN, ±inf,
    # ±0, a denormal; blocktopk's 11-bit offsets (messages of 59,184 bytes)
    sign_w = 20 + (d + 7) // 8
    tot = x + err0[rows]
    special = torch.tensor([-2**31, 0, 0x7FC00000, 0xFFC00001 - 2**32,
                            0x7F800000, 0xFF800000 - 2**32, 1,
                            0x807FFFFF - 2**32], dtype=torch.int32,
                           device=dev)
    pick = torch.rand(N_CLI, d, generator=g, device=dev) < 0.3
    which = torch.randint(0, special.numel(), (N_CLI, d), generator=g,
                          device=dev)
    tot_sp = torch.where(pick, special[which], tot.view(torch.int32)).view(
        torch.float32)
    msgs = torch.randint(0, 256, (N_CLI, sign_w), generator=g, device=dev,
                         dtype=torch.uint8)
    sc = torch.tensor([0x7FC00000, 0xFFC00001 - 2**32, 0x7F800000,
                       0xFF800000 - 2**32, 0, -2**31, 3, 0x3E4CCCCD,
                       0x3C23D70A, 0x3F800000], dtype=torch.int32,
                      device=dev)
    msgs[:, 16:20] = sc.view(torch.uint8).view(N_CLI, 4)
    sign_msgs = rows_case("sign, fused, special values", tot_sp, 1, msgs, 20,
                          torch.float32, scale_block=0)
    rows_case("sign, fused", tot, 1, msgs, 20, torch.float32, scale_block=0)
    dl = 2 * 300 + 7      # per-block scales
    msgs_b = torch.randint(0, 256, (N_CLI, 16 + 12 + (dl + 7) // 8),
                           generator=g, device=dev, dtype=torch.uint8)
    msgs_b[:, 16:28] = sc[torch.arange(3 * N_CLI, device=dev) % 10].view(
        torch.uint8).view(N_CLI, 12)
    rows_case("sign, fused, per-block scales", tot_sp[:, :dl].contiguous(),
              1, msgs_b, 28, torch.float32, scale_block=300)
    ib = 11
    li = torch.randint(0, BLOCK, (N_CLI, nb * k), generator=g, device=dev,
                       dtype=torch.int32)
    topk_w = 16 + (nb * k * ib + 7) // 8 + 4 * nb * k
    msgs11 = torch.randint(0, 256, (N_CLI, topk_w), generator=g, device=dev,
                           dtype=torch.uint8)
    idx_msgs = rows_case("blocktopk offsets n=11", li, ib, msgs11, 16,
                         torch.int32)
    # every width, c in {1, 3, 10}, odd row strides and offsets that leave
    # the streams at every alignment mod 16; uint8 values where n <= 8
    for c in (1, 3, N_CLI):
        for nbits in range(1, 33):
            count = 1000 + nbits
            col = (3 * nbits + c) % 16
            wide = col + (count * nbits + 7) // 8 + 5
            wide += 1 - wide % 2
            v = torch.randint(-2**31, 2**31 - 1, (c, count), generator=g,
                              device=dev, dtype=torch.int32)
            blk = torch.randint(0, 256, (c, wide), generator=g, device=dev,
                                dtype=torch.uint8)
            rows_case(f"n={nbits}, c={c}, col={col}", v, nbits, blk, col,
                      torch.int32)
            if nbits <= 8:
                rows_case(f"n={nbits}, c={c}, uint8", (v & ((1 << nbits) - 1))
                          .to(torch.uint8), nbits, blk, col, torch.uint8)
    # one-row calls (the 1-D wrappers) and their round trip
    bits = (torch.randn(d, generator=g, device=dev) >= 0).to(torch.uint8)
    idx = li[0].contiguous()
    for nbits, vals, dt, what in ((1, bits, torch.uint8, "n=1, one row"),
                                  (ib, idx, torch.int32, "n=11, one row")):
        got = ops.pack_uint_cuda(vals, nbits)
        want = ref.pack_uint(vals, nbits)
        back = ops.unpack_uint_cuda(got, nbits, vals.numel(), dt)
        torch.cuda.synchronize()
        same(f"pack_uint[{what}]", [got], [want])
        same(f"unpack_uint[{what}]", [back], [vals])
    nbytes1, nbytes11 = (d + 7) // 8, (nb * k * ib + 7) // 8
    blank = torch.empty_like(msgs)
    blank11 = torch.empty_like(msgs11)
    t = {
        "pack_uint": (
            lambda: ops.pack_uint_rows_cuda(tot, 1, blank, 20),
            lambda: ref.pack_uint_rows(tot, 1, blank, 20),
            N_CLI * (4 * d + nbytes1), N_CLI * d,
            lambda: ops.pack_uint_rows_cuda(li, ib, blank11, 16),
            lambda: ref.pack_uint_rows(li, ib, blank11, 16),
            N_CLI * (4 * nb * k + nbytes11), worst_p),
        "unpack_uint": (
            lambda: ops.unpack_uint_rows_cuda(sign_msgs, 20, 1, d,
                                              torch.float32, scale_col=16),
            lambda: ref.unpack_uint_rows(sign_msgs, 20, 1, d, torch.float32,
                                         scale_col=16),
            N_CLI * (4 + nbytes1 + 4 * d), N_CLI * d,
            lambda: ops.unpack_uint_rows_cuda(idx_msgs, 16, ib, nb * k),
            lambda: ref.unpack_uint_rows(idx_msgs, 16, ib, nb * k),
            N_CLI * (4 * nb * k + nbytes11), worst_u),
    }
    for name, (k1, p1, b1, f1, k11, p11, b11, worst) in t.items():
        out[name] = dict(
            ms=time_ms(k1, evict), plain_ms=time_ms(p1, evict, iters=10),
            ms_n11=time_ms(k11, evict), plain_ms_n11=time_ms(p11, evict),
            max_abs_err=worst, bytes=b1, flops=f1, bytes_n11=b11,
            library_ms=None,
            shapes=f"n=1: the sign codec's fused form over ({N_CLI},{d}) "
                   f"fp32 <-> ({N_CLI},{sign_w}) messages, stream at column "
                   f"20 (timed row); n=11: ({N_CLI},{nb * k}) int32 offsets "
                   f"<-> ({N_CLI},{topk_w}) messages at column 16 (ms_n11)")
    return out


# ---------------------------------------------------------------------------
# phase 2: the round on the card against the round on the CPU (small MLP)
# ---------------------------------------------------------------------------


def _route_cfg(route: str, m: int, n: int, k: int, fault=None, **over):
    """Route ``route``'s ``FedConfig`` at m clients, n a round, K steps;
    ``over`` replaces knobs (route j's sync twin, route k's resident
    twin)."""
    from repro_torch.configs.base import FedConfig
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=k, num_clients=m, participating=n,
              compressor="blocktopk", compress_ratio=RATIO,
              wire_block=BLOCK)
    kw.update({
        "a": dict(track_gamma=False, fused_ingest="auto"),
        "b": {},
        "c": dict(compressor="sign"),
        "d": dict(compressor="sign", wire=True),
        "e": dict(sparse_uplink=False),
        "f": dict(sparse_uplink=False, wire=True),
        "g": dict(compressor="sign", wire=True, two_way=True),
        "h": dict(wire=True, track_gamma=False, fault=fault),
        "i": dict(compressor="sign", track_gamma=False, fault=fault),
        "j": dict(wire=True, track_gamma=False, async_buffer=n // 2,
                  staleness_weight="inv_sqrt"),
        "k": dict(wire=True, track_gamma=False, ef_store=True,
                  client_chunk=n // 2, agg_groups=2),
        "l": dict(compressor="randk", client_chunk=n // 2),
    }[route])
    kw.update(over)
    return FedConfig(**kw)


def wire_network(m: int, straggler_prob: float = 0.05):
    """``examples/quickstart_wire.py``'s network: an uplink-constrained WAN
    with 5 % stragglers (route j raises the share)."""
    from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
    return SimulatedNetwork(NetworkConfig(uplink_mbps=10, downlink_mbps=50,
                                          straggler_prob=straggler_prob,
                                          seed=0), m)


@contextlib.contextmanager
def host_draws():
    """randk's positions drawn on the host and moved to the round's device,
    so a card and a CPU FedSim given equally seeded generators train on the
    same positions."""
    from repro_torch.core import compressors, sim as simmod
    draw = compressors.randk_positions
    simmod.randk_positions = (lambda rng, d, k, count, device: draw(
        rng, d, k, count, "cpu").to(device))
    try:
        yield
    finally:
        simmod.randk_positions = draw


def stacked(plan):
    """A plan's (ids, batches) rounds stacked as ``run_rounds`` takes them."""
    return (np.stack([ids for ids, _ in plan]),
            {key: np.stack([b[key] for _, b in plan]) for key in plan[0][1]})


def h_fault(plan, m: int, d: int):
    """Route h's ``FaultConfig``: the deadline is the 85th percentile of the
    client times the simulated network gives route h's messages over this
    run's cohorts, the seed the first whose plans over those rounds hold a
    crash, a corrupted delivered payload (a bit flip knocks an index out of
    range, so it is rejected) and a deadline cut. Host-side numpy only: the
    planner sees the same timings in the round."""
    from repro_torch.comm.faults import FaultConfig, FaultInjector
    from repro_torch.comm.transport import NetworkConfig, SimulatedNetwork
    from repro_torch.comm.wire import make_dense32_codec, make_wire_codec
    net = SimulatedNetwork(NetworkConfig(), m)
    up = make_wire_codec("blocktopk", RATIO, BLOCK).nbytes(d)
    down = make_dense32_codec().nbytes(d)
    timings = [net.round(ids, up, down, r) for r, (ids, _) in enumerate(plan)]
    deadline = float(np.quantile(np.concatenate(
        [t.client_times_s for t in timings]), 0.85))
    for seed in range(1000):
        cfg = FaultConfig(deadline_s=deadline, seed=seed, **FAULT_H)
        inj = FaultInjector(cfg, m)
        events = np.zeros(3)
        for r, ((ids, _), t) in enumerate(zip(plan, timings)):
            fp, info = inj.plan(ids, r, t)
            events += (info["crashed"], fp.corrupt.sum(),
                       info["deadline_cut"])
        if events.all():
            return cfg
    fail("route h: no fault seed below 1000 gives a crash, a rejection and "
         "a deadline cut")


@contextlib.contextmanager
def recording_norms(norms: list):
    """FedSim's dense validation, wrapped to append the L2 norms of the
    payloads it passes (before any clip) to ``norms``, one tensor a
    round."""
    from repro_torch.core import sim as simmod
    validate = simmod.validate_dense

    def recorded(hats, max_norm=0.0, truncated=None):
        out, valid = validate(hats, max_norm, truncated)
        norms.append(torch.linalg.vector_norm(hats[valid > 0], dim=-1).cpu())
        return out, valid

    simmod.validate_dense = recorded
    try:
        yield
    finally:
        simmod.validate_dense = validate


def i_fault(plan, m: int, n: int, k: int, loss, p0, dev):
    """Route i's ``FaultConfig``: round 0's first client crashes in rounds
    0-2, and the clip norm is the median norm of the payloads that a probe
    of round 0 (the same fault model, no clip) validates."""
    from repro_torch.comm.faults import FaultConfig
    from repro_torch.core.sim import FedSim
    trace = ((int(plan[0][0][0]), 0, 3),)
    sim = FedSim(loss, _route_cfg("i", m, n, k, FaultConfig(
        crash_trace=trace, **FAULT_I)), device=dev)
    norms = []
    with recording_norms(norms):
        sim.round(sim.init(p0), plan[0][1], plan[0][0])
    return FaultConfig(crash_trace=trace,
                       max_update_norm=float(torch.cat(norms).median()),
                       **FAULT_I)


def route_fault(route, plan, m, n, k, d, loss, p0, dev):
    if route == "h":
        return h_fault(plan, m, d)
    if route == "i":
        return i_fault(plan, m, n, k, loss, p0, dev)
    return None


def _reference_trainer(loss, p0, data):
    """Route g on both devices through ``FederatedTrainer.run``: the same
    client ids (drawn on the host), losses and params within phase 2's
    bounds, every wire counter equal."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.api import FederatedTrainer
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(fed=_route_cfg("g", 20, 4, 2),
                              train=TrainConfig(seed=0), loss_fn=loss,
                              init_params=p0, network=wire_network(20),
                              device=dev)
        tr.data = data
        runs[dev] = (tr.run(4, batch_size=8, log=None), tr._state)
    (hc, sc), (hg, sg) = runs["cpu"], runs["cuda"]
    rel = max(abs(g["loss"] - c["loss"]) / abs(c["loss"])
              for c, g in zip(hc, hg))
    wire = [k for k in hc[0] if k.startswith("wire") or k in (
        "bits", "round_time_s", "sim_time_s")]
    check(all(c[k] == g[k] for c, g in zip(hc, hg) for k in wire),
          "route g: the trainer's wire counters differ between card and CPU")
    dx = max_abs(sg.params.cpu(), sc.params)
    check(rel < 1e-4 and dx < 1e-4,
          f"route g: card vs CPU loss rel {rel}, params {dx}")
    return {"loss_rel": rel, "params_max_abs": dx}


def phase_reference():
    from repro_torch.core.sim import FedSim
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import count_params, init_params

    cfg = cm.MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
    data = FederatedClassification(num_clients=20, feature_dim=32, seed=0)
    loss = lambda p, b: cm.mlp_loss(p, b, cfg)
    defs = cm.mlp_defs(cfg)
    p0 = init_params(defs, torch.Generator().manual_seed(0))
    worst = {}
    for route in ROUTES:
        if route == "g":
            worst[route] = _reference_trainer(loss, p0, data)
            continue
        gen = torch.Generator().manual_seed(1)
        plan = []
        for r in range(4):
            idx = torch.randperm(20, generator=gen)[:4].numpy()
            plan.append((idx, data.round_batches(idx, r, 2, 8)))
        fault = route_fault(route, plan, 20, 4, 2, count_params(defs), loss,
                            p0, "cpu")
        fed = _route_cfg(route, 20, 4, 2, fault)
        sims = {dev: FedSim(loss, fed, device=dev) for dev in ("cpu", "cuda")}
        check(sims["cuda"]._fused == ("kernel" if route in ("a", "j")
                                       else "off"),
              f"route {route}: resolved fused_ingest={sims['cuda']._fused}")
        sts = {dev: s.init(p0) for dev, s in sims.items()}
        rel = 0.0
        verdicts = []
        if route == "j":      # the async engine consumes the staged plan
            ids, batches = stacked(plan)
            mets = {}
            for dev, s in sims.items():
                sts[dev], mets[dev] = s.run_rounds(sts[dev], batches, ids)
            keys = ("staleness_max", "buffer_fill", "bits", "wire_up_bytes",
                    "round_time_s", "sim_time_s")
            check(len(mets["cuda"]) == len(mets["cpu"]) and all(
                g[key] == c[key] for g, c in zip(mets["cuda"], mets["cpu"])
                for key in keys), f"route j: flushes differ between card "
                f"and CPU in {keys}")
            plan = []
            rel = max(abs(float(g["loss"]) - float(c["loss"]))
                      / abs(float(c["loss"]))
                      for g, c in zip(mets["cuda"], mets["cpu"]))
        for r, (idx, b) in enumerate(plan):
            mets = {}
            with host_draws():
                for dev, s in sims.items():
                    sts[dev], mets[dev] = s.round(
                        sts[dev], b, idx, torch.Generator().manual_seed(r))
            rel = max(rel, abs(float(mets["cuda"]["loss"])
                               - float(mets["cpu"]["loss"]))
                      / abs(float(mets["cpu"]["loss"])))
            if fault is not None:
                v = {dev: [float(m[k]) for k in VERDICTS]
                     for dev, m in mets.items()}
                check(v["cuda"] == v["cpu"],
                      f"route {route}: fault verdicts {VERDICTS} on the card "
                      f"{v['cuda']}, on the CPU {v['cpu']}")
                verdicts.append(v["cuda"])
        dx = max_abs(sts["cuda"].params.cpu(), sts["cpu"].params)
        check(rel < 1e-4 and dx < 1e-4,
              f"route {route}: card vs CPU loss rel {rel}, params {dx}")
        worst[route] = {"loss_rel": rel, "params_max_abs": dx}
        if fault is not None:
            worst[route]["verdicts"] = verdicts
    return worst


# ---------------------------------------------------------------------------
# phase 3: the slice, ConvMixer-256-8, every route
# ---------------------------------------------------------------------------


def _recording(codec, sizes: list):
    """``codec`` with an ``encode_rows`` that also appends the length of
    each message of the block it encodes to ``sizes``."""
    def encode_rows(tot):
        bufs = codec.encode_rows(tot)
        sizes.extend([bufs.shape[1]] * bufs.shape[0])
        return bufs
    return dataclasses.replace(codec, encode_rows=encode_rows)


def state_digest(st) -> dict:
    """SHA-256 of each part of the final state (the params x, the EF
    buffer, the server's m, v and v-hat), to hold two runs of a route equal
    to the bit."""
    parts = {"x": st.params, "ef": st.errors, "m": st.opt.m, "v": st.opt.v,
             "vhat": st.opt.vhat}
    out = {}
    for name, t in parts.items():
        h = hashlib.sha256()
        for part in (t if isinstance(t, tuple) else (t,)):
            h.update(part.detach().reshape(-1).contiguous()
                     .view(torch.uint8).cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]
    return out


def same_state(a, b) -> list:
    """The parts of two ``SimState`` that differ in any bit."""
    bad = []
    parts = {"params": (a.params, b.params), "errors": (a.errors, b.errors),
             "server_error": (a.server_error, b.server_error),
             "x_client": (a.x_client, b.x_client), "m": (a.opt.m, b.opt.m),
             "v": (a.opt.v, b.opt.v), "vhat": (a.opt.vhat, b.opt.vhat),
             "t": (a.opt.t, b.opt.t)}
    for name, (x, y) in parts.items():
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8)):
            bad.append(name)
    if (a.bits, a.round) != (b.bits, b.round):
        bad.append("bits/round")
    return bad


def route_g(loss, p0, data, d: int, rounds: int):
    """Route g through ``FederatedTrainer.run`` in a scratch working
    directory (the trainer writes ``ckpt_round3`` there), then ``save`` and
    ``load_pytree`` of the final state."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import state_from_jax, state_to_jax
    from repro_torch.core.api import FederatedTrainer
    from repro_torch.kernels import ops

    tr = FederatedTrainer(
        fed=_route_cfg("g", M, N_CLI, K_STEPS),
        train=TrainConfig(rounds=rounds, checkpoint_every=3,
                          log_every=rounds), loss_fn=loss, init_params=p0,
        network=wire_network(M))
    tr.data = data
    sizes, ms = [], []
    tr._sim.codec = _recording(tr._sim.codec, sizes)
    sim_round = tr._sim.round

    def timed_round(*args, **kw):
        t0 = time.perf_counter()
        out = sim_round(*args, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr._sim.round = timed_round
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            ops.reset_launches()
            hist = tr.run(rounds, batch_size=BATCH, log=None)
            counts = dict(ops.launches)
            ckpts = {c: json.loads((Path(tmp) / c / "manifest.json")
                                   .read_text())["meta"]
                     for c in os.listdir(tmp)}
            tr.save("final")
            tree, meta = load_pytree("final", state_to_jax(
                tr._state, tr._sim.unravel))
        finally:
            os.chdir(cwd)
    restored = state_from_jax(tree, "cuda")
    check(ckpts == {"ckpt_round3": {"round": 4, "algo": "fedcams"}},
          f"route g: checkpoints {ckpts}, expected ckpt_round3 only")
    check(meta == {"round": rounds, "algo": "fedcams"},
          f"route g: saved meta {meta}")
    diff = same_state(restored, tr._state)
    check(not diff, f"route g: the restored state differs in {diff}")
    check(counts["pack_uint"] == counts["unpack_uint"] == 2 * rounds,
          f"route g: pack_uint/unpack_uint launched {counts['pack_uint']}/"
          f"{counts['unpack_uint']} times in {rounds} rounds (2 a round)")
    check(counts["fedams_update"] == rounds,
          f"route g: fedams_update launched {counts['fedams_update']} times")
    nbytes = tr._sim.codec.nbytes(d)
    check(len(sizes) == rounds * (N_CLI + 1) and set(sizes) == {nbytes},
          f"route g: encoded sizes {sorted(set(sizes))} over {len(sizes)} "
          f"messages, codec.nbytes(d)={nbytes}")
    check(all(h["wire_up_bytes"] == h["wire_down_bytes"] == N_CLI * nbytes
              for h in hist), "route g: a round did not bill n compressed "
          "messages each way")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"route g: losses {losses}")
    st = tr._state
    check(not torch.equal(st.x_client, st.params),
          "route g: the clients see the server's exact model")
    for name, t in (("params", st.params), ("x_client", st.x_client),
                    ("errors", st.errors)):
        check(bool(torch.isfinite(t).all()), f"route g: non-finite {name}")
    wire = [{k: h[k] for k in ("wire_up_bytes", "wire_down_bytes",
                               "wire_bytes", "round_time_s", "sim_time_s")}
            for h in hist]
    return dict(round_ms=ms[1:], round0_ms=ms[0], loss=losses,
                gamma=[h["gamma"] for h in hist], launches=counts, wire=wire,
                checkpoints=ckpts, ef_buffer_mb=st.errors.numel() * 4 / 1e6,
                state_sha256=state_digest(st))


def check_fault_round(route, sim, st, met, before, fplan):
    """Route h or i after one round: the verdicts add up to n, the rows of
    the clients the server did not ingest (crashed, cut, or corrupted —
    bit flips of an index and NaNs are always rejected) equal their
    pre-round rows to the bit and the others moved, the state is finite,
    and the round's wall-clock keeps the deadline."""
    n = len(fplan.survivors)
    v = {k: float(met[k]) for k in VERDICTS}
    check(sum(v.values()) == n, f"route {route}: verdicts {v} do not add "
          f"up to n = {n}")
    dead = (fplan.survivors == 0) | (fplan.corrupt > 0)
    check(int(dead.sum()) == n - v["survivors"],
          f"route {route}: {int(dead.sum())} clients planned out, "
          f"{n - v['survivors']} not ingested")
    after = st.errors[before[0]].view(torch.int32)
    old = before[1].view(torch.int32)
    for p in range(n):
        kept = torch.equal(after[p], old[p])
        check(kept == bool(dead[p]),
              f"route {route}: client {int(before[0][p])}: ingested "
              f"{not dead[p]}, its EF row kept {kept}")
    for name, t in (("x", st.params), ("m", st.opt.m), ("v", st.opt.v),
                    ("vhat", st.opt.vhat), ("errors", st.errors)):
        check(bool(torch.isfinite(t).all()),
              f"route {route}: non-finite {name} after round {st.round}")
    cap = sim.faults.cfg.deadline_s
    if cap:
        check(met["round_time_s"] <= cap, f"route {route}: round_time_s "
              f"{met['round_time_s']} past the deadline {cap}")
    return v


def _plan(data, m: int, rounds: int):
    """``rounds`` cohorts of N_CLI ids of m (host generator, seed 1) and
    their batches."""
    from repro_torch.core.sampling import sample_clients
    gen = torch.Generator().manual_seed(1)
    plan = []
    for r in range(rounds):
        idx = sample_clients(gen, m, N_CLI).numpy()
        plan.append((idx, data.round_batches(idx, r, K_STEPS, BATCH)))
    return plan


def check_finite(route, st, losses):
    check(all(np.isfinite(losses)), f"route {route}: losses {losses}")
    for name, t in (("params", st.params), ("m", st.opt.m), ("v", st.opt.v),
                    ("vhat", st.opt.vhat), ("errors", st.errors)):
        check(bool(torch.isfinite(t).all()), f"route {route}: non-finite "
              f"{name}")


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def route_j(loss, p0, data, d: int, rounds: int):
    """Route j: the async engine over the staged cohorts, its launches
    counted per cohort and per flush; then B = n, uniform weights, 3
    cohorts against 3 sync rounds, bitwise, under deterministic
    algorithms."""
    from repro_torch.core.sim import FedSim
    from repro_torch.kernels import ops
    ids, batches = stacked(_plan(data, M, rounds))
    bsz = N_CLI // 2
    for p in (0.05, 0.2, 0.5):      # stragglers until some work is stale
        sim = FedSim(loss, _route_cfg("j", M, N_CLI, K_STEPS),
                     network=wire_network(M, p))
        check(sim._fused == "kernel" and sim._async is not None,
              f"route j: fused_ingest={sim._fused}, engine {sim._async}")
        st = sim.init(p0)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        st, mets = sim.run_rounds(st, batches, ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.launches)
        if max(m["staleness_max"] for m in mets) > 0:
            break
    else:
        fail("route j: no flush ingested stale work at straggler_prob 0.5")
    flushes = -(-rounds * N_CLI // bsz)
    check(len(mets) == flushes and st.round == flushes,
          f"route j: {len(mets)} flushes, expected {flushes}")
    check(counts["topk_ef_sparse"] == rounds and
          counts["fedams_ingest"] == flushes and
          counts["fedams_update"] == 0,
          f"route j: launches {counts} for {rounds} cohorts and {flushes} "
          f"flushes")
    check(any(m["buffer_fill"] < bsz or m["staleness_max"] > 0
              for m in mets), "route j: no flush partial or stale")
    losses = [float(m["loss"]) for m in mets]
    check_finite("j", st, losses)
    per_flush = [{"staleness_mean": m["staleness_mean"],
                  "staleness_max": m["staleness_max"],
                  "weight_sum": float(m["weight_sum"]),
                  "buffer_fill": m["buffer_fill"],
                  "round_time_s": m["round_time_s"]} for m in mets]
    print(f"route j: straggler_prob {p}: {len(mets)} flushes of "
          f"{rounds} cohorts in {ms:.1f} ms; per flush (staleness max, "
          f"weight_sum): {[(m['staleness_max'], round(m['weight_sum'], 4)) for m in per_flush]}")
    # B = n, unit weights: every flush is the sync round, to the bit
    with deterministic():
        cfg = dict(async_buffer=N_CLI, staleness_weight="uniform")
        sa = FedSim(loss, _route_cfg("j", M, N_CLI, K_STEPS, **cfg),
                    network=wire_network(M, p))
        ss = FedSim(loss, _route_cfg("j", M, N_CLI, K_STEPS, async_buffer=0),
                    network=wire_network(M, p))
        a, _ = sa.run_rounds(sa.init(p0), {k: v[:3] for k, v in
                                           batches.items()}, ids[:3])
        b = ss.init(p0)
        for r in range(3):
            b, _ = ss.round(b, {k: v[r] for k, v in batches.items()}, ids[r])
        diff = same_state(a, b)
    check(not diff, f"route j: async at B = n differs from the sync rounds "
          f"in {diff}")
    print("route j: B = n, uniform weights, 3 cohorts under deterministic "
          "algorithms: equal to 3 sync rounds to the bit")
    return dict(cohorts=rounds, flushes=len(mets), run_ms=ms, loss=losses,
                straggler_prob=p, per_flush=per_flush, launches=counts,
                anchor_bitwise=True, state_sha256=state_digest(st))


def route_k(loss, p0, d: int, rounds: int):
    """Route k: m = 1,000 with the EF store, chunks of 5 and 2 groups; then
    3 rounds against the resident buffer, bitwise, under deterministic
    algorithms."""
    from repro_torch.core.sim import FedSim
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.kernels import ops
    data = FederatedClassification(num_clients=M_K, image_shape=(32, 32, 3),
                                   alpha=0.3, seed=0)
    plan = _plan(data, M_K, rounds)
    sim = FedSim(loss, _route_cfg("k", M_K, N_CLI, K_STEPS))
    check(sim._fused == "off", f"route k: fused_ingest={sim._fused}")
    st = sim.init(p0)
    block = tuple(st.errors.shape)
    check(block == (N_CLI, d), f"route k: device EF block {block}")
    torch.cuda.synchronize()
    ops.reset_launches()
    ms, losses, tier2, nbytes = [], [], [], []
    for r, (idx, b) in enumerate(plan):
        t0 = time.perf_counter()
        st, met = sim.round(st, b, idx, prefetch_idx=plan[r + 1][0]
                            if r + 1 < rounds else None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        tier2.append(met["wire_tier2_bytes"])
        nbytes.append(sim._efs.nbytes)
    counts = dict(ops.launches)
    check(counts["topk_ef_sparse"] == 2 * rounds and
          counts["fedams_update"] == rounds and counts["fedams_ingest"] == 0,
          f"route k: launches {counts} in {rounds} rounds")
    check(tier2 == [2 * 4 * d] * rounds, f"route k: tier-2 bytes {tier2}")
    check_finite("k", st, losses)
    print(f"route k: device EF block {block} ({st.errors.numel() * 4 / 1e6:.1f}"
          f" MB; resident would be {M_K * d * 4 / 1e9:.2f} GB); host store "
          f"materialized bytes by round {nbytes}; wire_tier2_bytes {tier2[0]}")
    with deterministic():
        runs = {}
        for ef in (True, False):
            s = FedSim(loss, _route_cfg("k", M_K, N_CLI, K_STEPS,
                                        ef_store=ef))
            ids3, b3 = stacked(plan[:3])
            runs[ef] = (s, s.run_rounds(s.init(p0), b3, ids3)[0])
        (s_store, a), (_, b) = runs[True], runs[False]
        diff = [name for name in ("params", "x_client", "server_error")
                if not torch.equal(getattr(a, name), getattr(b, name))]
        diff += [name for name in ("m", "v", "vhat")
                 if not torch.equal(getattr(a.opt, name),
                                    getattr(b.opt, name))]
        for c0 in range(0, M_K, 100):   # every client's row, 100 at a time
            rows = torch.from_numpy(s_store._efs.gather(
                np.arange(c0, c0 + 100))).cuda()
            if not torch.equal(rows.view(torch.int32),
                               b.errors[c0:c0 + 100].view(torch.int32)):
                diff.append(f"EF rows {c0}..{c0 + 99}")
    check(not diff, f"route k: the EF store differs from the resident "
          f"buffer in {diff}")
    print(f"route k: 3 rounds under deterministic algorithms: params, server "
          f"state and all {M_K} EF rows equal the resident buffer's to the bit")
    return dict(round_ms=ms[1:], round0_ms=ms[0], loss=losses,
                launches=counts, ef_block=list(block),
                store_nbytes=nbytes, wire_tier2_bytes=tier2[0],
                resident_bitwise=True, state_sha256=state_digest(st))


def route_l(loss, p0, data, d: int, rounds: int):
    """Route l: randk 1/64 with γ on, chunks of 5; each round's drawn sets
    hold k distinct positions."""
    from repro_torch.core import sim as simmod
    from repro_torch.kernels import ops
    draw = simmod.randk_positions
    drawn = []

    def recorded(*args):
        out = draw(*args)
        drawn.append(out)
        return out

    sim = simmod.FedSim(loss, _route_cfg("l", M, N_CLI, K_STEPS))
    st = sim.init(p0)
    torch.cuda.synchronize()
    ops.reset_launches()
    ms, losses, gammas = [], [], []
    simmod.randk_positions = recorded
    try:
        for r, (idx, b) in enumerate(_plan(data, M, rounds)):
            t0 = time.perf_counter()
            st, met = sim.round(st, b, idx, torch.Generator().manual_seed(r))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            gammas.append(float(met["gamma"]))
    finally:
        simmod.randk_positions = draw
    counts = dict(ops.launches)
    check(counts["fedams_update"] == rounds and sum(counts.values()) ==
          rounds, f"route l: launches {counts} in {rounds} rounds")
    k = max(1, int(round(RATIO * d)))
    for sets in drawn:
        srt = sets.sort(dim=1).values
        check(sets.shape == (N_CLI + 2, k) and bool(
            (srt[:, 1:] != srt[:, :-1]).all()) and 0 <= int(srt.min())
            and int(srt.max()) < d,
            f"route l: drawn sets of shape {tuple(sets.shape)} are not k = "
            f"{k} distinct positions in [0, {d})")
    check(len(drawn) == rounds, f"route l: {len(drawn)} draws")
    check_finite("l", st, losses)
    check(all(np.isfinite(gammas)), f"route l: gamma {gammas}")
    return dict(round_ms=ms[1:], round0_ms=ms[0], loss=losses, gamma=gammas,
                launches=counts, k=k, state_sha256=state_digest(st))


def phase_slice(rounds: int = ROUNDS, routes=ROUTES):
    from repro_torch.core.sim import FedSim
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.kernels import ops
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import count_params, init_params

    cfg = cm.ConvMixerConfig()
    defs = cm.convmixer_defs(cfg)
    d = count_params(defs)
    check(d == 704266, f"ConvMixer-256-8 has d={d}")
    data = FederatedClassification(num_clients=M, image_shape=(32, 32, 3),
                                   alpha=0.3, seed=0)
    loss = lambda p, b: cm.convmixer_loss(p, b, cfg)
    p0 = init_params(defs, torch.Generator().manual_seed(0))
    res = {}
    for route in routes:
        if route == "g":
            res[route] = route_g(loss, p0, data, d, rounds)
            r = res[route]
            print(f"route g: round ms (round 0 excluded) "
                  f"{[round(t, 2) for t in r['round_ms']]}, median "
                  f"{np.median(r['round_ms']):.2f}; loss {r['loss']}; "
                  f"launches {r['launches']}; checkpoints "
                  f"{sorted(r['checkpoints'])}; the restored state equals "
                  f"the trainer's; final state sha256 {r['state_sha256']}")
            continue
        if route in ("j", "k", "l"):
            r = (route_k(loss, p0, d, rounds) if route == "k" else
                 {"j": route_j, "l": route_l}[route](loss, p0, data, d,
                                                      rounds))
            res[route] = r
            timing = (f"run ms {r['run_ms']:.1f}" if route == "j" else
                      f"round ms (round 0 excluded) "
                      f"{[round(t, 2) for t in r['round_ms']]}, median "
                      f"{np.median(r['round_ms']):.2f}")
            print(f"route {route}: {timing}; loss {r['loss']}; launches "
                  f"{r['launches']}; final state sha256 "
                  f"{r['state_sha256']}")
            continue
        plan = _plan(data, M, rounds)
        fault = route_fault(route, plan, M, N_CLI, K_STEPS, d, loss, p0,
                            "cuda")
        sim = FedSim(loss, _route_cfg(route, M, N_CLI, K_STEPS, fault))
        check(sim._fused == ("kernel" if route == "a" else "off"),
              f"route {route}: resolved fused_ingest={sim._fused}")
        sizes = []
        if sim.codec is not None:
            sim.codec = _recording(sim.codec, sizes)
        st = sim.init(p0)
        norms, verdicts = [], []
        record = (recording_norms(norms) if route == "i"
                  else contextlib.nullcontext())
        torch.cuda.synchronize()
        ops.reset_launches()
        ms, losses, gammas, wire = [], [], [], []
        with record:
            for idx, b in plan:
                if fault is not None:
                    rows = torch.as_tensor(idx, device="cuda")
                    before = (rows, st.errors[rows])
                    fplan, _ = sim.faults.plan(idx, st.round,
                                               sim._round_timing(idx,
                                                                 st.round))
                t0 = time.perf_counter()
                st, met = sim.round(st, b, idx)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
                gammas.append(float(met["gamma"]))
                if sim.codec is not None:
                    wire.append({key: met[key] for key in (
                        "wire_up_bytes", "wire_down_bytes", "wire_bytes",
                        "round_time_s", "sim_time_s")})
                if fault is not None:
                    verdicts.append(check_fault_round(route, sim, st, met,
                                                      before, fplan))
        counts = dict(ops.launches)
        for name in EXPECT[route]:
            check(counts[name] > 0, f"route {route}: {name} never launched")
        if fault is not None:
            check(counts["fedams_ingest"] == 0,
                  f"route {route}: fedams_ingest launched under faults")
            for name in EXPECT[route]:
                check(counts[name] == rounds, f"route {route}: {name} "
                      f"launched {counts[name]} times in {rounds} rounds")
        # the dense wire routes encode the (n, d) block: one launch of each
        # a round for all n clients (route h's sparse fp32 wire skips the
        # byte shuffle: its selections go through as what decoding gives)
        packed = sim.codec is not None and not sim.sparse
        if packed:
            check(counts["pack_uint"] == rounds and
                  counts["unpack_uint"] == rounds,
                  f"route {route}: pack_uint/unpack_uint launched "
                  f"{counts['pack_uint']}/{counts['unpack_uint']} times in "
                  f"{rounds} rounds")
            nbytes = sim.codec.nbytes(d)
            check(len(sizes) == rounds * N_CLI and set(sizes) == {nbytes},
                  f"route {route}: encoded buffer sizes {sorted(set(sizes))}"
                  f" over {len(sizes)} messages, codec.nbytes(d)={nbytes}")
        if sim.codec is not None:
            nbytes = sim.codec.nbytes(d)
            delivered = [N_CLI - v["crashed"] - v["deadline_cut"]
                         for v in verdicts] if fault else [N_CLI] * rounds
            check([w["wire_up_bytes"] for w in wire]
                  == [k * nbytes for k in delivered],
                  f"route {route}: uplink bytes per round "
                  f"{[w['wire_up_bytes'] for w in wire]}, delivered "
                  f"{delivered} × {nbytes}")
        if sim.codec is not None and fault is None:
            down = N_CLI * (4 * d + 16)
            check([w["wire_bytes"] for w in wire] == [
                (r + 1) * (N_CLI * nbytes + down) for r in range(rounds)],
                f"route {route}: cumulative wire bytes "
                f"{[w['wire_bytes'] for w in wire]}")
        check(all(np.isfinite(losses)), f"route {route}: losses {losses}")
        check(st.params.shape == (d,) and bool(torch.isfinite(
            st.params).all()), f"route {route}: non-finite params")
        check(bool(torch.isfinite(st.errors).all()),
              f"route {route}: non-finite EF buffer")
        res[route] = dict(round_ms=ms[1:], round0_ms=ms[0], loss=losses,
                          gamma=gammas, launches=counts, wire=wire,
                          ef_buffer_mb=st.errors.numel() * 4 / 1e6,
                          state_sha256=state_digest(st))
        if fault is not None:
            res[route].update(fault=dataclasses.asdict(fault),
                              verdicts=verdicts)
            print(f"route {route}: {fault}; verdicts {VERDICTS} per round "
                  f"{[list(v.values()) for v in verdicts]}")
        if route == "i":
            cap = fault.max_update_norm
            seen = torch.cat(norms)
            share = float((seen > cap).float().mean())
            check(0 < share, f"route i: no payload clipped at {cap}")
            res[route].update(clip_norm=cap, clipped_share=share)
            print(f"route i: clip norm {cap:.6g}, {share:.3f} of "
                  f"{seen.numel()} validated payloads clipped")
        print(f"route {route}: round ms (round 0 excluded) "
              f"{[round(t, 2) for t in ms[1:]]}, median "
              f"{np.median(ms[1:]):.2f}; loss {losses}; launches {counts}; "
              f"final state sha256 {res[route]['state_sha256']}")
    return res


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False — this script needs a card")
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(paths)} in {build_s:.1f} s")
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    t_phase = time.perf_counter()
    with deterministic():
        kern = phase_kernels(dev, 704266)
    print(f"phase 1 took {time.perf_counter() - t_phase:.1f} s")
    for name, r in kern.items():
        print(f"kernel {name} vs twin: {r['ms']:.4f} ms (twin "
              f"{r['plain_ms']:.4f} ms), max_abs_err {r['max_abs_err']}")
        if "ms_int8" in r:
            print("  bf16 / int8 state: "
                  f"{r['ms_bf16']:.4f} / {r['ms_int8']:.4f} ms; bound by "
                  f"dtype {r['bound_ms_by_dtype']}")
        if "ms_n11" in r:
            print(f"  n=11 rows: {r['ms_n11']:.4f} ms (twin "
                  f"{r['plain_ms_n11']:.4f} ms)")
        if "nearest_library_ms" in r:
            print(f"  nearest library call {r['nearest_library']}: "
                  f"{r['nearest_library_ms']:.4f} ms; selection blocks by "
                  f"digit passes 1-4: {r['select_passes']}")
    t_phase = time.perf_counter()
    refcheck = phase_reference()
    print(f"card vs CPU round (small MLP): {refcheck}")
    print(f"phase 2 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sl = phase_slice()
    print(f"phase 3 took {time.perf_counter() - t_phase:.1f} s")
    # route a again with deterministic algorithms: local training on the
    # card is not bit-reproducible otherwise, so only this run's final
    # state can be held equal to another build's to the bit
    with deterministic():
        det = phase_slice(rounds=3, routes=("a",))["a"]

    rows = []
    for name, r in kern.items():
        runs = [(route, sl[route]["launches"][name]) for route in ROUTES]
        per_round = {route: n / ROUNDS for route, n in runs if n}
        print(f"kernel {name}: {r['ms']:.4f} ms median of 30, {r['bytes']} "
              f"bytes, launches per round (per cohort on j) {per_round}")
        b_ms, b_by = bound(r["bytes"], r["flops"])
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{_build.SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            "launches": sum(n for _, n in runs),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"]})
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__,
         "build_s": build_s, "kernels": kern, "kernel_rows": rows,
         "reference": refcheck, "slice": sl,
         "route_a_deterministic": det}, indent=1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
