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
   options at a ragged N, also with NaN deltas. Then every kernel at each
   shape route m launches it (``phase_mesh_shapes``): for each
   ConvMixer-256-8 leaf size and the flat d a (1, d) row at the leaf's
   block layout (blocks of 128, 256 and 2048, ragged last blocks) and k,
   on random and hard inputs; ``fedams_update`` at every leaf and ZeRO
   shard size; ``fedams_ingest`` on 4 gathered clients (one of them a
   non-participant) and on 1; and ``topk_ef_sparse`` and ``fedams_ingest``
   at every shape routes o, q, s, u and w launch them (``phase_lm_shapes``:
   gemma2-2b's leaves at 2 layers, 2,304 to 589,824,000 values a row, the
   ingest on 2 clients; qwen2-moe-a2.7b's at 1 layer, 2,048 to 311,164,928
   values, the (1, 60, 2048, 1408) expert stacks of 173,015,040 among
   them; route s's deepseek-v3 cut, 512 to 117,440,512 values (its
   (1, 8, 7168, 2048) expert stacks); recurrentgemma-2b's at 5 layers,
   2,560 to 655,360,000 values (its tied table); the ingest on 1 client;
   route w's xlstm-350m leaves as a rank at tp 2 holds them, 1,024 to
   50,331,648 values, the ingest on 2 clients).
   All bitwise (a NaN must meet a NaN).
   Each kernel is timed with CUDA events (median of 30 launches, L2
   flushed before each) beside its twin and its bound, and the two large
   ones also alone on each LM route's largest leaf (route o's
   589,824,000, q's 311,164,928, s's 117,440,512, u's 655,360,000 and
   w's 50,331,648 values) beside their bytes bounds;
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
   that each round bills n of them uplink;
4. runs the mesh backend (``core.mesh``): route m on four gloo ranks
   sharing the card — ConvMixer-256-8 as one flat leaf, 3 rounds of
   blocktopk ``sparse_topk`` fused and two-pass, equal to the port's
   FedSim to the bit; then the model's 52-leaf tree, 6 rounds each of
   sparse at n = 3 of 4, hierarchical (2 × 2), packed sign, dense
   blocktopk, dense sign, ZeRO-sharded server state, crashes with bit
   flips, and 3 rounds through ``FederatedTrainer(mesh=...).run`` — and
   route m1, the sparse fused round on one NCCL rank. Each job checks its
   kernels' launches a round, finite losses, ``wire_up_bytes`` against
   ``mesh_wire_bytes_tiers``, and that every shape at which a rank
   launched a kernel (``record_launch_shapes``) is one phase 1 held
   against the twin;
5. serves gemma2-2b at its published widths (route n, 26 layers, seeded
   weights, bf16 compute) through ``launch/serve.py``: batch 4 × prompt
   512 + 32 tokens, then one 4,608-token prompt (past the 4096 window and
   2·chunk at q-chunk 256, so the ring caches wrap) + 16 tokens; tokens in
   range, logits finite; prefill + decode against the full-sequence
   forward at full width, 2 layers, fp32; the smoke config's loss, prefill
   and decode on the card against the CPU. Prints prefill ms, decode ms a
   token, tokens/s and peak memory;
6. trains gemma2-2b on the mesh (route o: published widths, 2 layers,
   745,549,056 params in 20 leaves) through ``launch/train.py``'s
   ``train`` on two gloo ranks sharing the card: fedcams, blockwise top-k
   1/64 over the sparse collective, the fused ingest through
   ``KernelImpl``, K = 2, batch 2 × 512 a client, 3 rounds. Each rank
   launches ``topk_ef_sparse`` and ``fedams_ingest`` once a leaf a round,
   at shapes phase 1 held; ``wire_up_bytes`` equals
   ``mesh_wire_bytes_tiers``; losses finite. Prints the reckoned and the
   measured peak memory a rank and rank 0's round ms;
7. serves qwen2-moe-a2.7b at its published widths and full depth (route
   p, 24 layers, 14,315,735,040 params, 57.3 GB of fp32 weights, bf16
   compute) through ``launch/serve.py``: batch 4 × prompt 512 + 32 tokens
   (``serve``), then batch 16 × prompt 128 + 16 on the same weights (decode
   at C = 2 slots an expert, not 1); tokens in range, logits finite;
   prefill + decode against the full-sequence forward at full width, 2
   layers, fp32, capacity factor 15 (= E/k, so that decode drops no token
   the forward keeps); one layer's ``moe_ffn`` against
   ``moe_ffn_dense_ref`` (T = 2048, capacity factor 15, fp32); the
   dispatch on the card bitwise the CPU's on the same probs; the smoke
   config's loss, aux, prefill and decode on the card against the CPU.
   Prints the init's seconds, prefill ms, decode ms a token, tokens/s and
   peak memory beside the reckoned peak;
8. trains qwen2-moe-a2.7b on the mesh (route q: published widths, 1 layer,
   1,192,890,368 params in 19 leaves, ~53.7 GB: one rank) through
   ``launch/train.py``'s ``train`` on one NCCL rank: fedcams, blockwise
   top-k 1/64 over the sparse collective, the fused ingest, K = 2, batch
   2 × 512, 3 rounds. 19 ``topk_ef_sparse`` + 19 ``fedams_ingest`` a
   round at shapes phase 1 held; ``wire_up_bytes`` as billed; losses and
   every local step's aux loss finite, the aux loss > 0. Prints round ms
   and peak memory;
9. serves deepseek-v3-671b at its published widths (route r: MLA with the
   absorbed decode over its latent cache, 256 experts top-8 and a shared
   one; reduced to 1 of 61 layers and no MTP block, which serving never
   runs: 13,360,651,264 params, 53.44 GB of fp32 weights drawn on the card
   from a seeded CUDA generator, bf16 compute) through
   ``launch/serve.py``, as route n: batch 4 × 512 + 32, then 1 × 4,608 +
   16 at q-chunk 256 (18 MLA q-chunks). Then, on the same weights in fp32
   at capacity factor 32 (= E/k: decode drops nothing the forward keeps),
   prefill + absorbed decode against the decompressed forward; and the
   smoke config (its MTP head included) on the card against the CPU.
   Prints the peak memory beside ``serve_reckoning``'s;
10. trains deepseek-v3 on the mesh (route s: published d_model, heads and
   MLA dims with the MTP block; reduced to 1 layer, 8 of 256 experts at
   the published expert width, top-2, a vocabulary of 8,192;
   1,387,296,768 params in 41 leaves) on one NCCL rank, as route q: 41
   ``topk_ef_sparse`` + 41 ``fedams_ingest`` a round; every local step's
   aux loss and MTP cross entropy finite and > 0;
11. serves recurrentgemma-2b at its published widths and full depth (route
   t: 26 layers, (RG-LRU, RG-LRU, local attention) × 8 and two RG-LRU
   layers, 2,658,690,560 params, 10.63 GB fp32, bf16 compute) as route n:
   the 4,608-token prompt is past the 2,048 window, so the rings wrap
   while the RG-LRU state carries. Decode against the forward at 5 layers,
   fp32, a prompt of 2,100 (past the window); the smoke config on the card
   against the CPU;
12. trains recurrentgemma-2b on the mesh (route u: published widths,
   reduced to 5 layers — one period and the 2-layer tail — 1,043,453,440
   params in 67 leaves) on one NCCL rank, as route q: 67
   ``topk_ef_sparse`` + 67 ``fedams_ingest`` a round;
13. serves xlstm-350m at its published widths and depth (route v: 24
   layers alternating mLSTM and sLSTM, 343,856,128 params, bf16 compute)
   as route n: batch 4 × 512 + 32, then 1 × 4,608 + 16 (two mLSTM
   q-chunks of 2,304; the sLSTM steps 4,608 times a layer); decode against
   the forward at 4 layers, fp32; the smoke config on the card against the
   CPU;
14. trains xlstm-350m at full depth on the mesh at dp 2 × tp 2 (route w:
   four gloo ranks sharing the card, each holding its model shards) through
   ``launch/train.py``'s ``train``: fedcams, blockwise top-k 1/64 over the
   sparse collective, the fused ingest, K = 2, batch 2 × 512 a client, 3
   rounds, 19 ``topk_ef_sparse`` + 19 ``fedams_ingest`` a rank a round on
   its model-local leaves at shapes phase 1 held, every replicated leaf of
   the final state the same on all four ranks to the bit; then dense
   FedAvg rounds in fp32 at one and two local steps, at dp 2 × tp 2 and
   at dp 2 × tp 1 from the same seeded init, the loss and the gathered
   params held together (at two steps within ten times what the tp 1
   round reads on the card against the host's CPU);
15. runs the model axis on the card (route x): gemma2-2b at full width and
   depth served at tp 2 on two gloo ranks (route n's weights; the prefill
   logits against route n's, the share of greedy tokens that agree), and
   in fp32 against tp 1 at 2 layers within 1e-4, at 26 within 1e-3;
   qwen2-moe-a2.7b at
   published widths, 2 layers and 58 experts at tp 4 (padded to 60): no
   pad expert chosen, decode = forward; a decode over a cache split across
   2 ranks of the sequence axis against the unsharded one within 1e-5.
Every model route prints its seconds.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Exits nonzero, with no result,
without CUDA or when any check fails. Longer output goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
# phase 1, continued: each kernel at every shape route m launches it
# ---------------------------------------------------------------------------

#: a launch's shape signature, per kernel, from the arguments of its CUDA
#: entry point: what phase 1 holds against the twin and route m records
SIGS = {
    "topk_ef_sparse": lambda x, err, rows, *, k, block, **_: (
        tuple(x.shape), tuple(err.shape), k, block),
    "topk_ef": lambda x, err, rows, *, k, block, **_: (
        tuple(x.shape), tuple(err.shape), k, block),
    "sign_ef": lambda x, err, rows, **_: (tuple(x.shape), tuple(err.shape)),
    "fedams_update": lambda x, *_, option=1, **__: (x.numel(), option),
    "fedams_ingest": lambda x, m, v, vh, vals, *_, block=2048,
    state_dtype="float32", option=1, **__: (
        x.numel(), tuple(vals.shape), block, state_dtype, option),
}


def record_launch_shapes() -> dict:
    """Wrap each kernel's CUDA entry point in ``kernels.ops`` (in this
    process) so that it also records its launch's :data:`SIGS` signature;
    returns kernel name -> the set of signatures seen. The functions of
    ``ops`` look their entry points up at call time, so every path to a
    kernel is recorded; the launch counts are untouched."""
    from repro_torch.kernels import ops
    seen = {}
    for name, sig in SIGS.items():
        fn = getattr(ops, f"{name}_cuda")
        got = seen[name] = set()

        def recorded(*a, _fn=fn, _sig=sig, _got=got, **kw):
            _got.add(_sig(*a, **kw))
            return _fn(*a, **kw)

        setattr(ops, f"{name}_cuda", recorded)
    return seen


def mesh_kernel_shapes():
    """The sizes route m runs its kernels at, derived from
    ConvMixer-256-8's defs as the mesh derives them: each leaf's size (one
    (1, d_leaf) row a leaf) and the flat anchor's d; the slices that
    ``shard_server_state`` updates (``state_shard_dim`` at M_MESH shards);
    and the client counts the fused ingest gathers (M_MESH ranks, m1's
    one)."""
    from repro_torch.core.mesh import state_shard_dim
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import tree_leaves
    defs = tree_leaves(cm.convmixer_defs(cm.ConvMixerConfig()))
    sizes = [int(np.prod(dref.shape)) for dref in defs]
    leaves = sorted(set(sizes) | {sum(sizes)})
    shards = sorted({n // M_MESH for n, dref in zip(sizes, defs)
                     if state_shard_dim(dref, M_MESH) is not None})
    return leaves, shards, (M_MESH, 1)


def _hold(out, route, name, what, kern, twin, args, kw, inplace=None):
    """The kernel and its twin on the same inputs, bitwise; both update
    argument ``inplace`` (a copy each), compared after. Counts the case,
    its worst |error| and its :data:`SIGS` signature into ``out[name]``."""
    a_k, a_r = list(args), list(args)
    if inplace is not None:
        a_k[inplace] = args[inplace].clone()
        a_r[inplace] = args[inplace].clone()
    got, want = kern(*a_k, **kw), twin(*a_r, **kw)
    got = list(got) if isinstance(got, tuple) else [got]
    want = list(want) if isinstance(want, tuple) else [want]
    if inplace is not None:
        got.append(a_k[inplace])
        want.append(a_r[inplace])
    torch.cuda.synchronize()
    same(f"{name}[{route}, {what}]", got, want)
    rec = out[name]
    rec[0] += 1
    rec[1] = max([rec[1]] + [max_abs(a.float(), b.float()) for a, b in
                             zip(got, want) if a.is_floating_point()])
    rec[2].add(SIGS[name](*a_k, **kw))


def phase_mesh_shapes(dev) -> dict:
    """Every kernel at each shape route m launches it
    (:func:`mesh_kernel_shapes`), bitwise against its twin: for each leaf
    size d a (1, d) row at the leaf's block layout and k, on random
    inputs and on ``ref.topk_hard_cases`` (a leaf narrower than their six
    2048-value segments takes the first d values of each segment in
    turn); ``fedams_update`` at every leaf and shard size;
    ``fedams_ingest`` on the gathered selections of n clients (n = M_MESH,
    once more with one of them a non-participant's zeros and n_div =
    M_MESH - 1; n = 1); both FedAMS options. Returns kernel name ->
    [cases, worst |error|, the :data:`SIGS` signatures held]."""
    from repro_torch.core.compressors import block_layout
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(2)
    leaves, shards, gathered = mesh_kernel_shapes()
    out = {name: [0, 0.0, set()] for name in SIGS}
    rows = torch.zeros(1, dtype=torch.int64, device=dev)
    hold = lambda *a, **k: _hold(out, "route m", *a, **k)

    seg = 2048
    hard_all = ref.topk_hard_cases(1, 12 * seg, seed=3).to(dev)
    for d in leaves:
        bs, _ = block_layout(d, BLOCK)
        k = max(1, int(round(RATIO * bs)))
        negz = torch.full((1, d), -0.0, device=dev)
        inputs = [("random", torch.randn(1, d, generator=g, device=dev) * 0.01,
                   torch.randn(1, d, generator=g, device=dev) * 0.003)]
        if d >= 6 * seg:
            inputs.append(("hard", ref.topk_hard_cases(1, d, seed=d).to(dev),
                           negz))
        else:
            inputs += [(f"hard segment {i}", hard_all[:, i * seg:i * seg + d]
                        .contiguous(), negz) for i in range(6)]
        for what, x, e in inputs:
            what = f"d={d}, block={bs}, k={k}, {what}"
            hold("topk_ef_sparse", what, ops.topk_ef_sparse_cuda,
                 ref.topk_ef_sparse, (x, e, rows), dict(k=k, block=bs), 1)
            hold("topk_ef", what, ops.topk_ef_cuda, ref.topk_ef, (x, e, rows),
                 dict(k=k, block=bs), 1)
            hold("sign_ef", what, ops.sign_ef_cuda, ref.sign_ef, (x, e, rows),
                 {}, 1)
    kw = dict(eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4)
    for n in sorted(set(leaves) | set(shards)):
        ins = (torch.randn(n, generator=g, device=dev),
               torch.randn(n, generator=g, device=dev) * 1e-3,
               torch.rand(n, generator=g, device=dev) * 1e-4,
               torch.rand(n, generator=g, device=dev) * 2e-4,
               torch.randn(n, generator=g, device=dev) * 1e-2)
        for option in (1, 2):
            hold("fedams_update", f"N={n}, option {option}",
                 ops.fedams_update_cuda, ref.fedams_update_ref, ins,
                 dict(kw, option=option))
    for d in leaves:
        bs, _ = block_layout(d, BLOCK)
        k = max(1, int(round(RATIO * bs)))
        v = torch.rand(d, generator=g, device=dev) * 1e-4
        st = (torch.randn(d, generator=g, device=dev),
              torch.randn(d, generator=g, device=dev) * 1e-3, v,
              v + torch.rand(d, generator=g, device=dev) * 1e-4)
        for n in gathered:
            vals, idx = ref.topk_ef_sparse(
                torch.randn(n, d, generator=g, device=dev),
                torch.zeros(n, d, device=dev), torch.arange(n, device=dev),
                k=k, block=bs)
            cohorts = [(n, vals * 0.01)]
            if n > 1:
                cohorts.append((n - 1, cohorts[0][1].clone()))
                cohorts[1][1][-1] = 0.0          # a non-participant's zeros
            for n_div, vv in cohorts:
                for option in (1, 2):
                    hold("fedams_ingest",
                         f"d={d}, block={bs}, k={k}, n={n}, n_div={n_div}, "
                         f"option {option}", ops.fedams_ingest_cuda,
                         ref.fedams_ingest_ref, (*st, vv, idx),
                         dict(kw, n_div=float(n_div), block=bs, option=option,
                              state_dtype="float32"))
    return out


#: route o's model: gemma2-2b at its published widths, 2 of its 26 layers
#: (the mesh state of 26 layers would be ~104 GB a rank; PERF.md §4)
LM_LAYERS = 2
LM_CLIENTS = 2      # route o's ranks, one client each
LM_ROUNDS = 3
#: routes o and q's leaves above this many values are held on random inputs
#: only: the hard cases' numpy generator takes ~1 min at 589,824,000
#: values, and their 2048-value blocks are the blocks every smaller leaf
#: holds
LM_HARD_MAX = 1 << 25
#: route q's model: qwen2-moe-a2.7b at its published widths, 1 of its 24
#: layers, on ONE rank (~53.7 GB: two ranks do not fit the card; PERF.md
#: §4)
MOE_LAYERS = 1
MOE_ROUNDS = 3


def lm_cfg(arch: str = "gemma2-2b", layers: int = LM_LAYERS):
    """``arch`` at its published widths, ``layers`` layers (route o:
    gemma2-2b at ``LM_LAYERS``)."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    return mreplace(get_arch(arch).model, num_layers=layers)


def moe_cfg():
    """Route q's model: qwen2-moe-a2.7b at ``MOE_LAYERS`` layers."""
    return lm_cfg("qwen2-moe-a2.7b", MOE_LAYERS)


def leaf_sizes(cfg, tp: int = 1) -> list:
    """Each leaf's size on one rank of a model axis of ``tp``."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import local_shape, tree_leaves
    return [int(np.prod(local_shape(d, {"model": tp})))
            for d in tree_leaves(Model(cfg, tp=tp).defs())]


#: route w: xlstm-350m at its published widths and depth (24 layers,
#: 343,856,128 params in 19 leaves) on dp ``W_DP`` × tp ``W_TP``: four gloo
#: ranks sharing the card. Its step sizes are the train CLI's ``--eta-l
#: 0.001 --eta 0.01``: at the defaults (η_l = 0.05) the first local step
#: drives an mLSTM input gate below -88, where the normalizer's exp(-m)
#: overflows and the reference's and the port's backward give NaN (ROADMAP
#: Queue 3 item 27); at η_l = 0.001 its rounds stay finite on the card
W_DP, W_TP, W_ROUNDS, W_ETA, W_ETA_L = 2, 2, 3, 0.01, 0.001


def w_fed():
    """Route w's ``FedConfig``: route o's at ``W_DP`` clients, η ``W_ETA``
    and η_l ``W_ETA_L``."""
    return dataclasses.replace(lm_fed(W_DP), eta=W_ETA, eta_l=W_ETA_L)


def xlstm_cfg():
    """Routes v and w's model: xlstm-350m at its published widths and
    depth (bf16 compute, the config's)."""
    from repro_torch.configs.registry import get_arch
    return get_arch("xlstm-350m").model


#: route s's model: deepseek-v3-671b at published d_model, heads and MLA
#: dims with its MTP block; reduced: 1 of 61 layers, 8 of 256 experts at
#: the published expert width, top-2 of 8, a vocabulary of 8,192 of
#: 129,280 (1,387,296,768 params in 41 leaves, ~5.55 GB a copy: the two
#: published tables alone are 1.85 B values, and a rank holds ~11 copies)
MLA_TRAIN = dict(num_layers=1, vocab_size=8192, num_experts=8, top_k=2)
MLA_ROUNDS = 3
#: route u's model: recurrentgemma-2b at published widths, 5 of its 26
#: layers: one (RG-LRU, RG-LRU, attention) period and the 2-layer tail, as
#: the full stack plans (1,043,453,440 params in 67 leaves)
RG_LAYERS = 5
RG_ROUNDS = 3


def mla_train_cfg():
    """Route s's model (``MLA_TRAIN``)."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("deepseek-v3-671b").model
    return mreplace(cfg, num_layers=MLA_TRAIN["num_layers"],
                    vocab_size=MLA_TRAIN["vocab_size"],
                    moe=dataclasses.replace(
                        cfg.moe, num_experts=MLA_TRAIN["num_experts"],
                        top_k=MLA_TRAIN["top_k"]))


def rg_train_cfg():
    """Route u's model: recurrentgemma-2b at ``RG_LAYERS`` layers."""
    return lm_cfg("recurrentgemma-2b", RG_LAYERS)


def lm_kernel_shapes() -> dict:
    """The leaf sizes routes o, q, s, u and w select and ingest (one
    (1, d_leaf) row a leaf; route w's are each rank's model-local leaves
    at tp = ``W_TP``) → the client counts their fused ingests gather at
    that size (route o's ``LM_CLIENTS``, route w's ``W_DP``, the others'
    one)."""
    out = {}
    for cfg, n, tp in ((lm_cfg(), LM_CLIENTS, 1), (moe_cfg(), 1, 1),
                       (mla_train_cfg(), 1, 1), (rg_train_cfg(), 1, 1),
                       (xlstm_cfg(), W_DP, W_TP)):
        for d in leaf_sizes(cfg, tp):
            out.setdefault(d, set()).add(n)
    return {d: sorted(out[d]) for d in sorted(out)}


def phase_lm_shapes(dev, out: dict) -> dict:
    """``topk_ef_sparse`` and ``fedams_ingest`` at every shape routes o,
    q, s, u and w launch them (:func:`lm_kernel_shapes`), bitwise against
    the twins, into ``out`` (:func:`phase_mesh_shapes`'s record): for each
    leaf size d (512 to recurrentgemma-2b's 655,360,000-value tied
    embedding; route w's xlstm-350m leaves as a rank at tp = 2 holds them,
    1,024 to 50,331,648 values) a
    (1, d) row on random inputs, and on ``ref.topk_hard_cases`` up to
    ``LM_HARD_MAX`` values; the fused ingest of the routes' client counts'
    selections (made by the selection kernel on random totals), option 1,
    and option 2 up to ``LM_HARD_MAX``. The largest row's twins hold
    several 2.4 GB tensors; each leaf's are freed before the next.

    The largest leaf of each route (route o's 589,824,000-value table,
    route q's 311,164,928-value untied one, route s's 117,440,512-value
    expert stacks, route u's 655,360,000-value table, route w's
    50,331,648-value replicated sLSTM input projections) is also timed
    alone:
    each
    kernel's CUDA-event ms (median of 30, L2 flushed, the EF row restored
    before each selection) beside its bytes bound. Returns those times by
    leaf size."""
    from repro_torch.core.compressors import block_layout
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(4)
    hold = lambda *a, **k: _hold(out, "routes o, q, s, u, w", *a, **k)
    rows = torch.zeros(1, dtype=torch.int64, device=dev)
    leaves = lm_kernel_shapes()
    largest = {max(leaf_sizes(lm_cfg())): ("o", LM_CLIENTS),
               max(leaf_sizes(moe_cfg())): ("q", 1),
               max(leaf_sizes(mla_train_cfg())): ("s", 1),
               max(leaf_sizes(rg_train_cfg())): ("u", 1),
               max(leaf_sizes(xlstm_cfg(), W_TP)): ("w", W_DP)}
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)
    timed = {}
    seg = 2048
    kw = dict(eta=0.5, beta1=0.9, beta2=0.99, eps=1e-3)
    for d, gathered in leaves.items():
        bs, _ = block_layout(d, BLOCK)
        k = max(1, int(round(RATIO * bs)))
        inputs = [("random", torch.randn(1, d, generator=g, device=dev)
                   * 0.01, torch.randn(1, d, generator=g, device=dev) * 0.003)]
        if d <= LM_HARD_MAX:
            negz = torch.full((1, d), -0.0, device=dev)
            if d >= 6 * seg:
                inputs.append(("hard", ref.topk_hard_cases(1, d, seed=d).to(
                    dev), negz))
            else:
                hard = ref.topk_hard_cases(1, 12 * seg, seed=3).to(dev)
                inputs += [(f"hard segment {i}", hard[:, i * seg:i * seg + d]
                            .contiguous(), negz) for i in range(6)]
        for what, x, e in inputs:
            hold("topk_ef_sparse", f"d={d}, block={bs}, k={k}, {what}",
                 ops.topk_ef_sparse_cuda, ref.topk_ef_sparse, (x, e, rows),
                 dict(k=k, block=bs), 1)
        if d in largest:
            xt, et0 = inputs[0][1:]
            et = et0.clone()

            def restore():
                et.copy_(et0)
                flush.sum()    # read 256 MB: L2 holds nothing used

            nbytes = 3 * 4 * d + -(-d // bs) * k * 8 + 8
            timed[d] = {"route": largest[d][0], "topk_ef_sparse": dict(
                ms=time_ms(lambda: ops.topk_ef_sparse_cuda(
                    xt, et, rows, k=k, block=bs, check_rows=False),
                    restore),
                bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_S * 1e3)}
            del xt, et, et0
        del inputs, x, e
        torch.cuda.empty_cache()
        v = torch.rand(d, generator=g, device=dev) * 1e-4
        st = (torch.randn(d, generator=g, device=dev),
              torch.randn(d, generator=g, device=dev) * 1e-3, v,
              v + torch.rand(d, generator=g, device=dev) * 1e-4)
        del v
        for n in gathered:
            tot = torch.randn(n, d, generator=g, device=dev)
            vals, idx = ops.topk_ef_sparse_cuda(
                tot, torch.zeros_like(tot), torch.arange(n, device=dev),
                k=k, block=bs)
            del tot
            torch.cuda.empty_cache()
            for option in ((1, 2) if d <= LM_HARD_MAX else (1,)):
                hold("fedams_ingest", f"d={d}, block={bs}, k={k}, n={n}, "
                     f"option {option}", ops.fedams_ingest_cuda,
                     ref.fedams_ingest_ref, (*st, vals * 0.01, idx),
                     dict(kw, n_div=float(n), block=bs, option=option,
                          state_dtype="float32"))
                torch.cuda.empty_cache()
            if d in largest and n == largest[d][1]:
                sel = (vals * 0.01, idx)
                nbytes = 2 * 4 * 4 * d + vals.numel() * 8
                timed[d]["fedams_ingest"] = dict(
                    ms=time_ms(lambda: ops.fedams_ingest_cuda(
                        *st, *sel, n_div=float(n), block=bs, option=1,
                        state_dtype="float32", **kw), flush.sum),
                    bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_S * 1e3,
                    clients=n)
                del sel
                torch.cuda.empty_cache()
        del st
        torch.cuda.empty_cache()
    return timed


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


# ---------------------------------------------------------------------------
# route m: the mesh backend, four ranks sharing the card over gloo; m1: one
# NCCL rank
# ---------------------------------------------------------------------------

M_MESH = 4          # route m's ranks, one client each
ANCHOR_ROUNDS = 3   # the flat model's rounds held to FedSim's to the bit
#: ConvMixer-256-8's leaves: the mesh selects, ingests and updates per leaf
LEAVES = 52


class ConvMixerModel:
    """ConvMixer-256-8 as a mesh model (``core.mesh``'s duck type): its own
    per-leaf param tree."""

    tp = 1

    def __init__(self, cfg):
        self.cfg = cfg

    def defs(self):
        from repro_torch.models import convmixer as cm
        return cm.convmixer_defs(self.cfg)

    def loss(self, p, b, ctx, remat_policy="none", chunk=0):
        from repro_torch.models import convmixer as cm
        return cm.convmixer_loss(p, b, self.cfg)

    def train_batch_defs(self, global_batch, seq_len):
        from repro_torch.models.params import ParamDef
        c = self.cfg
        return {"x": ParamDef((global_batch, c.image, c.image, c.channels)),
                "y": ParamDef((global_batch,), dtype="int32")}


class FlatConvMixer(ConvMixerModel):
    """The same model with its params as ONE leaf ``{"w": (d,)}`` in ravel
    order — FedSim's flat vector, so the mesh's per-leaf blocks are
    FedSim's blocks and the two rounds can be held equal to the bit."""

    def __init__(self, cfg, unravel, d: int):
        super().__init__(cfg)
        self.unravel, self.d = unravel, d

    def defs(self):
        from repro_torch.models.params import ParamDef
        return {"w": ParamDef((self.d,))}

    def loss(self, p, b, ctx, remat_policy="none", chunk=0):
        from repro_torch.models import convmixer as cm
        return cm.convmixer_loss(self.unravel(p["w"]), b, self.cfg)


class ClientBatches:
    """``lm_data`` for the mesh: round r's global batch, client-major —
    client i's K steps of B rows at rows [i·B, (i+1)·B), what
    ``FederatedClassification.round_batches`` gives FedSim's cohort
    [0, m)."""

    def __init__(self, data, m: int):
        self.data, self.m = data, m

    def mesh_batch(self, r, local_steps, global_batch, seq_len):
        b = global_batch // self.m
        rb = self.data.round_batches(np.arange(self.m), r, local_steps, b)
        return {k: np.ascontiguousarray(np.swapaxes(v, 0, 1).reshape(
            (local_steps, global_batch) + v.shape[3:])) for k, v in
            rb.items()}


def mesh_cfg(**over):
    """Route m's ``FedConfig``: fedcams, blocktopk 1/64 over the sparse
    client-axis collective, M_MESH clients on ("data",), K = 3."""
    from repro_torch.configs.base import FedConfig
    kw = dict(algorithm="fedcams", eta=0.1, eps=1e-4, eta_l=0.05,
              local_steps=K_STEPS, num_clients=M_MESH, compressor="blocktopk",
              compress_ratio=RATIO, aggregation="sparse",
              client_axes=("data",), track_gamma=False)
    kw.update(over)
    return FedConfig(**kw)


def mesh_jobs():
    """name → the mesh run: its config overrides, mesh shape and axes, the
    flat model or the per-leaf tree, rounds, deterministic algorithms, and
    the launches a round each rank must make (every other kernel: none)."""
    from repro_torch.comm.faults import FaultConfig
    per_leaf = lambda **k: {n: LEAVES for n in k["kernels"]}
    flat = dict(shape=(M_MESH,), axes=("data",), flat=True,
                rounds=ANCHOR_ROUNDS, det=True, gather=True)
    leaf = dict(shape=(M_MESH,), axes=("data",), flat=False, rounds=ROUNDS,
                det=False, gather=False)
    return {
        "anchor-fused": dict(flat, cfg={}, expect={"topk_ef_sparse": 1,
                                                   "fedams_ingest": 1}),
        "anchor-twopass": dict(flat, cfg=dict(fused_ingest="off"),
                               expect={"topk_ef_sparse": 1,
                                       "fedams_update": 1}),
        "sparse-3of4": dict(leaf, cfg=dict(participating=3), expect=per_leaf(
            kernels=("topk_ef_sparse", "fedams_ingest"))),
        "hier": dict(leaf, shape=(2, 2), axes=("cgroup", "data"),
                     cfg=dict(agg_groups=2, client_axes=("cgroup", "data")),
                     expect=per_leaf(kernels=("topk_ef_sparse",
                                              "fedams_update"))),
        "packed-sign": dict(leaf, cfg=dict(compressor="packedsign"),
                            expect=per_leaf(kernels=("fedams_update",))),
        "dense-blocktopk": dict(leaf, cfg=dict(aggregation="dense"),
                                expect=per_leaf(kernels=("topk_ef",
                                                         "fedams_update"))),
        "dense-sign": dict(leaf, cfg=dict(compressor="sign",
                                          aggregation="dense"),
                           expect=per_leaf(kernels=("sign_ef",
                                                    "fedams_update"))),
        "shard": dict(leaf, cfg=dict(shard_server_state=True,
                                     state_shards=M_MESH),
                      expect=per_leaf(kernels=("topk_ef_sparse",
                                               "fedams_update"))),
        "faults": dict(leaf, cfg=dict(fault=FaultConfig(
            crash_prob=0.25, corrupt_prob=0.25)), expect=per_leaf(
                kernels=("topk_ef_sparse", "fedams_update"))),
        # the user's entry point: FederatedTrainer(mesh=...).run
        "trainer": dict(leaf, cfg={}, rounds=ANCHOR_ROUNDS, trainer=True,
                        expect=per_leaf(kernels=("topk_ef_sparse",
                                                 "fedams_ingest"))),
    }


def _mesh_job(job: dict) -> dict:
    """One mesh run on this rank: build the round with a CUDA KernelImpl,
    stage its batches, then — launch counters at 0 — drive ``rounds``
    rounds and read the counters. Returns the per-round metrics, round ms,
    the launches, the wire bytes ``mesh_wire_bytes_tiers`` bills, and
    (``gather``) the global state."""
    import torch.distributed as dist

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import mesh as meshmod
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import init_params, ravel, tree_leaves
    from repro_torch.sharding.rules import ParallelContext

    fed = mesh_cfg(**job["cfg"])
    m = fed.num_clients
    cfg = cm.ConvMixerConfig()
    p0 = init_params(cm.convmixer_defs(cfg), torch.Generator().manual_seed(0),
                     "cuda")
    flat0, unravel = ravel(p0)
    model = (FlatConvMixer(cfg, unravel, flat0.numel()) if job["flat"]
             else ConvMixerModel(cfg))
    data = ClientBatches(FederatedClassification(
        num_clients=M, image_shape=(32, 32, 3), alpha=0.3, seed=0), m)
    mesh = make_mesh(job["shape"], job["axes"], "cuda")
    ctx = ParallelContext(client_axes=fed.client_axes, num_clients=m,
                          mesh=mesh)
    train = TrainConfig(global_batch=m * BATCH, seq_len=1,
                        remat_policy="none")
    rnd = meshmod.build_fed_round(model, fed, train, ctx,
                                  kernel_impl=ops.KernelImpl())
    state = meshmod.init_fed_state(model, fed,
                                   torch.Generator().manual_seed(0), ctx,
                                   "cuda")
    if job["flat"]:
        state = state._replace(params={"w": flat0})
    if job.get("trainer"):
        return _trainer_job(job, fed, model, data, mesh, train)
    batches = [meshmod.shard_batch(data.mesh_batch(r, K_STEPS, m * BATCH, 1),
                                   model, fed, train, ctx, "cuda")
               for r in range(job["rounds"])]
    tiers = meshmod.mesh_wire_bytes_tiers(fed, model.defs())
    res = {"loss": [], "wire_up_bytes": [], "survivors": [], "rejected": [],
           "round_ms": [], "expected_wire": float(np.float32(
               m * tiers["tier1"] + fed.agg_groups * tiers["tier2"])),
           "tiers": tiers}
    # the last ``profile_last`` rounds run under torch.profiler (m1: its
    # NCCL kernels; scripts/profile_round.py m: rank 0's trace)
    from torch.profiler import ProfilerActivity, profile
    prof = None
    with (deterministic() if job["det"] else contextlib.nullcontext()):
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        for r, b in enumerate(batches):
            if r == len(batches) - job.get("profile_last", 0):
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            t0 = time.perf_counter()
            state, met = rnd(state, b, r)
            torch.cuda.synchronize()
            res["round_ms"].append((time.perf_counter() - t0) * 1e3)
            for k in ("loss", "wire_up_bytes", "survivors", "rejected"):
                if k in met:
                    res[k].append(float(met[k]))
        if prof is not None:
            prof.stop()
        res["launches"] = dict(ops.launches)
    if prof is not None:
        res["nccl_device_events"] = sorted(
            e.key for e in prof.key_averages() if "nccl" in e.key.lower()
            and max(getattr(e, "device_time_total", 0),
                    getattr(e, "cuda_time_total", 0)) > 0)
        if job.get("trace") and dist.get_rank() == 0:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    res["trace"] = json.load(f)["traceEvents"]
    if job["gather"]:
        full = meshmod.gather_fed_state(state, model, fed, ctx)
        res["state"] = {f: {k: v.detach().cpu() for k, v in
                            getattr(full, f).items()}
                        for f in ("params", "m", "v", "vhat", "errors")}
    res["finite"] = all(bool(torch.isfinite(t).all()) for part in (
        state.params, state.m, state.v, state.vhat, state.errors)
        for t in tree_leaves(part))
    return res


def _trainer_job(job, fed, model, data, mesh, train) -> dict:
    """``FederatedTrainer(mesh=...)`` on the card: ``rounds`` rounds of
    ``run`` (the round the trainer builds, with its CUDA KernelImpl), the
    launch counters at 0 just before."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.core import mesh as meshmod
    from repro_torch.core.api import FederatedTrainer
    from repro_torch.kernels import ops
    from repro_torch.models.params import tree_leaves

    trainer = FederatedTrainer(fed=fed, train=dc.replace(
        train, rounds=job["rounds"]), model=model, lm_data=data, mesh=mesh,
        device="cuda")
    tiers = meshmod.mesh_wire_bytes_tiers(fed, model.defs())
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.run(log=None)
    torch.cuda.synchronize()
    st = trainer._state
    return {"loss": [h["loss"] for h in hist],
            "wire_up_bytes": [h["wire_up_bytes"] for h in hist],
            "survivors": [], "rejected": [], "tiers": tiers,
            "round_ms": [(time.perf_counter() - t0) * 1e3 / len(hist)],
            "expected_wire": float(np.float32(fed.num_clients
                                              * tiers["tier1"])),
            "launches": dict(ops.launches),
            "finite": all(bool(torch.isfinite(t).all()) for part in (
                st.params, st.m, st.v, st.vhat, st.errors)
                for t in tree_leaves(part))}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_rank(rank, world, port, outdir, backend, jobs, fn, record):
    """One rank: on the card (one card: every rank's device 0), TF32 off,
    the host's cores split among the ranks, the process group over
    ``backend``; runs ``fn`` on each of ``jobs`` (with ``record``, also
    the shapes of the kernels each launched, :func:`record_launch_shapes`,
    under ``"shapes"``) and writes the results to
    ``outdir/rank{rank}.pt``."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    seen = record_launch_shapes() if record else None
    try:
        out = {}
        for name, job in jobs.items():
            out[name] = fn(job)
            if record:
                out[name]["shapes"] = {k: set(v) for k, v in seen.items()}
                for v in seen.values():
                    v.clear()
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, backend: str, jobs: dict, fn=None,
              timeout: float = 600, record=None) -> list:
    """``fn`` (default :func:`_mesh_job`, a module-level function) on each
    of ``jobs`` on ``world`` spawned ranks (``torch.multiprocessing``);
    each rank's results, in rank order, those of :func:`_mesh_job` with
    the shapes its kernels were launched at (``record``, default: with
    :func:`_mesh_job` only). A rank that fails or outlives
    ``timeout`` fails the run (the others are stopped)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _mesh_rank, args=(world, _free_port(), tmp, backend, jobs,
                              fn or _mesh_job,
                              fn is None if record is None else record),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    fail(f"{backend} ranks still running after {timeout} s")
        except Exception as e:   # a rank raised or died: ctx stopped the rest
            fail(f"a {backend} rank failed: {e}")
        codes = [p.exitcode for p in ctx.processes]
        check(codes == [0] * world, f"{backend} rank exit codes {codes}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _anchor_fedsim(loss, p0, data, fused: bool):
    """FedSim on route m's flat anchor: m = n = 4 (cohort [0, 4)), the
    fused round (``track_gamma=False``) or the two-pass one (γ on),
    ANCHOR_ROUNDS rounds under deterministic algorithms."""
    from repro_torch.core.sim import FedSim
    fed = mesh_cfg(client_axes=(), track_gamma=not fused, wire_block=BLOCK)
    sim = FedSim(loss, fed)
    check(sim._fused == ("kernel" if fused else "off"),
          f"route m anchor: FedSim resolved fused_ingest={sim._fused}")
    st = sim.init(p0)
    ids = np.arange(M_MESH)
    losses = []
    with deterministic():
        for r in range(ANCHOR_ROUNDS):
            st, met = sim.round(st, data.round_batches(ids, r, K_STEPS,
                                                       BATCH), ids)
            losses.append(float(met["loss"]))
    return st, losses


def check_shapes_held(route: str, results: list, held: dict) -> dict:
    """Fail unless every shape at which ``results`` (the ranks' results
    of one job) launched a kernel was held against the twin by
    :func:`phase_mesh_shapes` (``held``); returns kernel -> the count of
    distinct shapes launched."""
    shapes = {k: set().union(*(r["shapes"][k] for r in results))
              for k in SIGS}
    unheld = {k: sorted(v - held[k][2]) for k, v in shapes.items()
              if v - held[k][2]}
    check(not unheld, f"route {route}: kernels launched at shapes phase 1 "
          f"did not hold against their twins: {unheld}")
    return {k: len(v) for k, v in shapes.items() if v}


def route_m(loss, p0, data, held) -> dict:
    """Route m: every mesh job on four gloo ranks sharing the card (every
    shape a kernel is launched at held by phase 1, ``held``), then the
    flat anchors against FedSim in this process, bitwise."""
    jobs = mesh_jobs()
    ranks = run_ranks(M_MESH, "gloo", jobs)
    res = {}
    for name, job in jobs.items():
        r0 = ranks[0][name]
        n_shapes = check_shapes_held(f"m {name}",
                                     [rk[name] for rk in ranks], held)
        launches = {k: sum(rk[name]["launches"][k] for rk in ranks)
                    for k in r0["launches"]}
        want = {k: job["expect"].get(k, 0) * M_MESH * job["rounds"]
                for k in launches}
        check(launches == want, f"route m {name}: launches {launches}, "
              f"expected {want}")
        check(all(rk[name]["loss"] == r0["loss"] for rk in ranks),
              f"route m {name}: the ranks' losses differ")
        check(all(np.isfinite(r0["loss"])) and all(
            rk[name]["finite"] for rk in ranks),
              f"route m {name}: losses {r0['loss']} or a non-finite state")
        check(r0["wire_up_bytes"] == [r0["expected_wire"]] * job["rounds"],
              f"route m {name}: wire_up_bytes {r0['wire_up_bytes']}, "
              f"mesh_wire_bytes_tiers bills {r0['expected_wire']}")
        per_round = {k: v / job["rounds"] for k, v in launches.items() if v}
        res[name] = {k: v for k, v in r0.items()
                     if k not in ("state", "shapes")}
        res[name]["launches"] = launches
        res[name]["shapes_held"] = n_shapes
        print(f"route m {name}: loss {r0['loss']}; wire_up_bytes "
              f"{r0['wire_up_bytes'][0]:.0f} a round (tiers {r0['tiers']}); "
              f"launches a round, all ranks {per_round}; round ms "
              f"{[round(t, 1) for t in r0['round_ms']]}; distinct launch "
              f"shapes, each held by phase 1: {n_shapes}")
        if r0["survivors"]:
            check(sum(r0["rejected"]) > 0 and min(r0["survivors"]) < M_MESH,
                  f"route m {name}: no crash or no rejection in "
                  f"{job['rounds']} rounds")
            print(f"route m {name}: survivors {r0['survivors']}, rejected "
                  f"{r0['rejected']} per round")
    for name, fused in (("anchor-fused", True), ("anchor-twopass", False)):
        st, losses = _anchor_fedsim(loss, p0, data, fused)
        mesh = ranks[0][name]["state"]
        want = {"params": st.params, "m": st.opt.m, "v": st.opt.v,
                "vhat": st.opt.vhat, "errors": st.errors}
        bad = [f for f, t in want.items() if not torch.equal(
            mesh[f]["w"].view(torch.int32), t.cpu().view(torch.int32))]
        check(not bad and ranks[0][name]["loss"] == losses,
              f"route m {name}: the mesh differs from FedSim in {bad}; "
              f"losses {ranks[0][name]['loss']} vs {losses}")
        res[name]["equals_fedsim"] = True
        print(f"route m {name}: {ANCHOR_ROUNDS} rounds equal FedSim's to the "
              f"bit (params, m, v, v-hat, the {M_MESH} EF rows, losses)")
    return res


def route_m1(held) -> dict:
    """Route m1: the sparse fused per-leaf round on ONE NCCL rank (NCCL
    refuses two ranks on one card): the production backend starts, and
    the profiler sees its collectives run on the card. Every shape a
    kernel is launched at is held by phase 1 (``held``)."""
    job = dict(mesh_jobs()["sparse-3of4"], cfg=dict(num_clients=1),
               shape=(1,), rounds=ANCHOR_ROUNDS, profile_last=ANCHOR_ROUNDS,
               expect={"topk_ef_sparse": LEAVES, "fedams_ingest": LEAVES})
    r0 = run_ranks(1, "nccl", {"m1": job})[0]["m1"]
    r0["shapes_held"] = check_shapes_held("m1", [r0], held)
    del r0["shapes"]
    want = {k: job["expect"].get(k, 0) * job["rounds"]
            for k in r0["launches"]}
    check(r0["launches"] == want, f"route m1: launches {r0['launches']}, "
          f"expected {want}")
    check(all(np.isfinite(r0["loss"])) and r0["finite"],
          f"route m1: losses {r0['loss']}")
    check(r0["wire_up_bytes"] == [r0["expected_wire"]] * job["rounds"],
          f"route m1: wire_up_bytes {r0['wire_up_bytes']}")
    check(bool(r0["nccl_device_events"]),
          "route m1: no NCCL kernel ran on the card")
    print(f"route m1 (nccl, 1 rank): loss {r0['loss']}; NCCL device events "
          f"{r0['nccl_device_events']}; round ms "
          f"{[round(t, 1) for t in r0['round_ms']]}")
    return r0



# ---------------------------------------------------------------------------
# route n: serving gemma2-2b at full width; route o: federated LM training on
# the mesh at published widths, 2 layers
# ---------------------------------------------------------------------------

#: route n's runs through launch/serve.py: (batch, prompt, gen, q-chunk).
#: The second prompt is past gemma2-2b's 4096 window and past 2·chunk, so
#: the local layers take the banded chunked path (band 4352 < 4608 keys)
#: and their ring caches wrap; the reference's q-chunking needs chunk | S,
#: and 256 is the largest chunk dividing 4608 whose band is short of S
SERVE_RUNS = ((4, 512, 32, 2048), (1, 4608, 16, 256))
#: decode against the full-sequence forward: gemma2-2b's widths, 2 layers,
#: fp32; a prompt of 96, 8 decode steps; logits within this share of the
#: largest |logit| (cuBLAS sums the prefill's, the decode's and the
#: forward's GEMMs in their own orders; TF32 off)
DECODE_TOL = 1e-4
#: the card against the CPU on the gemma2-2b smoke config (fp32, TF32 off)
CARD_TOL = 1e-4


#: each serving route's first run: its prefill's last-position logits and
#: its greedy tokens (route x holds its tp = 2 run against route n's)
SERVED = {}


def _serve_summary(out, batch, gen, peak, vocab) -> dict:
    toks = out["tokens"]
    return {"tokens_in_range": bool(((toks >= 0) & (toks < vocab)).all()),
            "finite": out["finite"], "prefill_ms": out["prefill_s"] * 1e3,
            "decode_ms_per_token": out["decode_s"] * 1e3 / max(gen - 1, 1),
            "tokens_per_s": batch * (gen - 1) / max(out["decode_s"], 1e-9),
            "peak_gb": peak / 1e9, "tokens": toks[:, :8].tolist()}


def _rel_err(got, want) -> float:
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().abs().max())


def decode_vs_forward(model, params, P: int, steps: int, seed: int,
                      ctx=None) -> float:
    """Prefill P tokens and decode ``steps`` - 1 more on the card, against
    the full-sequence forward's logits at the same positions; returns the
    largest |difference| over the largest |logit|. ``ctx``: a rank's
    context over a model axis (the logits gathered over it), None: one
    process."""
    from repro_torch.sharding.rules import ParallelContext
    ctx = ctx or ParallelContext()
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, size=(2, P + steps)).astype(np.int32)).cuda()
    gathered = lambda lg: ctx.all_gather_model(lg, -1)
    with torch.no_grad():
        full = gathered(model.encode(params, {"tokens": toks}, ctx))
        lg, caches = model.prefill(params, toks[:, :P], ctx, max_len=P + steps)
        got = [gathered(lg)]
        for i in range(steps - 1):
            lg, caches = model.decode_step(params, toks[:, P + i:P + i + 1],
                                           caches, P + i, ctx,
                                           max_len=P + steps)
            got.append(gathered(lg))
    return _rel_err(torch.stack(got, 1), full[:, P - 1:P + steps - 1])


def smoke_card_vs_cpu(arch: str, chunk: int = 2048) -> float:
    """``arch``'s smoke config (seeded weights) on the card against the
    CPU: the loss and each of its metrics (ce, aux, mtp_ce where the model
    has them), the prefill of 48 tokens and 8 decode steps; returns the
    largest |difference| over the largest |value|, across them."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map
    from repro_torch.sharding.rules import ParallelContext
    ctx = ParallelContext()
    cs = get_arch(arch).smoke
    ms = Model(cs)
    pc = ms.init(torch.Generator().manual_seed(3), "cpu")
    pg = tree_map(lambda t: t.cuda(), pc)
    r = np.random.default_rng(4)
    toks = torch.from_numpy(r.integers(0, cs.vocab_size, size=(2, 64)).astype(
        np.int32))
    labels = torch.from_numpy(r.integers(0, cs.vocab_size, size=(2, 64))
                              .astype(np.int32))
    outs = {}
    with torch.no_grad():
        for name, p in (("cpu", pc), ("cuda", pg)):
            dev = p["final_norm"].device
            t = toks.to(dev)
            loss, met = ms.loss(p, {"tokens": t, "labels": labels.to(dev)},
                                ctx, remat_policy="none", chunk=chunk)
            lg, c = ms.prefill(p, t[:, :48], ctx, max_len=64, chunk=chunk)
            seq = [loss.reshape(1, 1)] + [met[k].reshape(1, 1)
                                          for k in sorted(met)] + [lg]
            for i in range(48, 56):
                lg, c = ms.decode_step(p, t[:, i:i + 1], c, i, ctx,
                                       max_len=64)
                seq.append(lg)
            outs[name] = seq
    return max(_rel_err(a, b) if float(b.abs().max()) else
               float((a.cpu() - b).abs().max())
               for a, b in zip(outs["cuda"], outs["cpu"]))


def serve_route(route: str, cfg, generator, runs=None) -> dict:
    """``cfg`` served through ``launch/serve.py``: ``serve`` on the first of
    ``runs`` ((batch, prompt, gen, q-chunk); default ``SERVE_RUNS``: batch
    4, prompt 512, gen 32; weights from ``generator``, None: the host's
    seed 0), then ``generate`` on the same weights for each other run
    (``SERVE_RUNS``: batch 1, a 4,608-token prompt, gen 16, q-chunk 256).
    Tokens in range, logits finite, each run's peak memory beside
    ``serve_reckoning``'s; the port's kernels launch no time. Returns the
    runs' numbers and the params."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params

    runs = runs or SERVE_RUNS
    model = Model(cfg)
    d = count_params(model.defs())
    res = {"params": d, "num_params_config": cfg.num_params(),
           "reckoned_peak_gb": {b: serve_reckoning(model, d, b, s + g)
                                for b, s, g, _ in runs}}
    print(f"route {route}: {cfg.name}, {cfg.num_layers} layers, {d:,} params "
          f"(ModelConfig.num_params() reads {cfg.num_params():,}), "
          f"{4 * d / 1e9:.2f} GB fp32; reckoned peak "
          f"{res['reckoned_peak_gb']} GB")
    ops.reset_launches()
    params = None
    for batch, prompt, gen, chunk in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if params is None:
            out = tserve.serve(cfg, batch=batch, prompt_len=prompt, gen=gen,
                               device="cuda", generator=generator)
            params = out.pop("params")
            res["init_s"] = out["init_s"]
            print(f"route {route}: the weights drawn in {out['init_s']:.1f} s")
        else:
            prompts = np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(batch, prompt)).astype(np.int32)
            out = tserve.generate(model, params, prompts, gen, chunk=chunk)
        run = _serve_summary(out, batch, gen,
                             torch.cuda.max_memory_allocated(),
                             cfg.vocab_size)
        SERVED.setdefault(route, (out["logits0"], out["tokens"]))
        check(run["tokens_in_range"] and run["finite"],
              f"route {route} b{batch} s{prompt}: tokens out of range or "
              f"logits not finite: {run}")
        res[f"batch {batch}, prompt {prompt}, gen {gen}"] = run
        print(f"route {route}: batch {batch}, prompt {prompt}, gen {gen}, "
              f"q-chunk {chunk}: prefill {run['prefill_ms']:.1f} ms, decode "
              f"{run['decode_ms_per_token']:.2f} ms/token, "
              f"{run['tokens_per_s']:.1f} tok/s, peak {run['peak_gb']:.2f} GB "
              f"(reckoned {res['reckoned_peak_gb'][batch]:.2f})")
        del out
    gc.collect()
    torch.cuda.empty_cache()
    check(not any(ops.launches.values()),
          f"route {route}: serving launched the port's kernels {ops.launches}")
    return res, params


def route_n() -> dict:
    """Route n: gemma2-2b served at its published widths (26 layers, bf16
    compute on fp32 weights drawn on the card from a CUDA generator seeded
    0, which route x's tp = 2 ranks draw again)
    through ``launch/serve.py``: ``serve`` (batch 4, prompt 512, gen 32),
    then ``generate`` on the same weights with a 4,608-token prompt (gen
    16, q-chunk 256). Tokens in range and logits finite. Then the decode
    path against the full-sequence forward (published widths, 2 layers,
    fp32), and the smoke config's loss, prefill and decode on the card
    against the CPU. The port's kernels launch no time."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("gemma2-2b").model
    check(cfg.num_layers == 26 and cfg.d_model == 2304
          and cfg.vocab_size == 256000, "route n: not gemma2-2b's widths")
    res, params = serve_route("n", cfg, torch.Generator(
        device="cuda").manual_seed(0))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # decode against the full-sequence forward, full width, 2 layers, fp32
    m2 = Model(mreplace(cfg, num_layers=2, dtype="float32"))
    p2 = m2.init(torch.Generator().manual_seed(1), "cuda")
    P, steps = 96, 8
    dec_err = decode_vs_forward(m2, p2, P, steps, seed=2)
    del p2
    torch.cuda.empty_cache()
    check(dec_err <= DECODE_TOL, f"route n: prefill + decode differ from "
          f"the full-sequence forward by {dec_err} of the largest logit")
    res["decode_vs_forward_rel_err"] = dec_err
    print(f"route n: prefill + {steps - 1} decode steps vs the full-sequence "
          f"forward (published widths, 2 layers, fp32): max |diff| "
          f"{dec_err:.3g} of the largest logit (tolerance {DECODE_TOL})")

    # the card against the CPU on the smoke config
    card_err = smoke_card_vs_cpu("gemma2-2b", chunk=16)
    check(card_err <= CARD_TOL, f"route n: the smoke config on the card "
          f"differs from the CPU by {card_err} of the largest value")
    res["card_vs_cpu_rel_err"] = card_err
    print(f"route n: gemma2-2b smoke loss, prefill (chunked, banded) and 8 "
          f"decode steps on the card vs the CPU: max |diff| {card_err:.3g} "
          f"of the largest value (tolerance {CARD_TOL})")
    return res


#: route p's runs through launch/serve.py: (batch, prompt, gen). Decode
#: runs the MoE on T = B tokens, so at B = 4 an expert has C = 1 slot and
#: at B = 16 it has 2
MOE_SERVE_RUNS = ((4, 512, 32, 2048), (16, 128, 16, 2048))
#: decode against the forward at qwen2-moe's widths takes capacity factor
#: 15 = E/k, so that C = T on both paths: at the published 1.25 decode
#: drops every token that shares an expert with another, as the
#: reference's does, and the forward does not
MOE_DECODE_CF = 15.0
#: the smoke config on the card against the CPU (fp32, TF32 off)
MOE_CARD_TOL = 1e-5
#: one layer's moe_ffn against moe_ffn_dense_ref at published widths, fp32
#: (the gathered and the dense einsums sum in their own orders)
MOE_DENSE_TOL = 1e-5


def host_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def serve_reckoning(model, d: int, batch: int, max_len: int) -> float:
    """What a serving route holds at its peak, reckoned from the shapes
    (GB): the fp32 weights, a MoE layer's three bf16 expert casts, the bf16
    unembedding, a (batch, vocab) fp32 logits row and its bf16 twin, and
    the decode caches (k/v, MLA's latents or RG-LRU's state, from
    ``Model.cache_defs``) twice (a decode step restacks the layers' new
    caches before the old ones go)."""
    from repro_torch.models.params import leaves_with_paths
    cfg = model.cfg
    mo = cfg.moe
    casts = 0 if mo is None else 3 * (mo.num_experts * cfg.d_model
                                      * mo.d_ff_expert * 2)
    unembed = cfg.vocab_size * cfg.d_model * 2
    caches = 2 * sum(int(np.prod(c.shape)) * getattr(torch, c.dtype).itemsize
                     for _, c in leaves_with_paths(model.cache_defs(
                         batch, max_len)))
    quad = 0
    if cfg.xlstm is not None:
        # the mLSTM's quadratic prefill: ~6 fp32 (batch, q-chunk, S, heads)
        # temporaries of one chunk live (D, its mask, w, s, s·w, their grad-
        # free products)
        n = max(max_len // 2048, 1)
        quad = 6 * batch * (max_len // n) * max_len * cfg.num_heads * 4
    return (4 * d + casts + unembed + batch * cfg.vocab_size * 6
            + caches + quad) / 1e9


def route_p() -> dict:
    """Route p: qwen2-moe-a2.7b served at its published widths and full
    depth (24 layers, bf16 compute on fp32 weights from
    ``torch.Generator().manual_seed(0)``) through ``launch/serve.py``:
    ``serve`` (batch 4, prompt 512, gen 32), then ``generate`` on the same
    weights (batch 16, prompt 128, gen 16). Tokens in range and logits
    finite. Then, at published widths: prefill + decode against the
    full-sequence forward (2 layers, fp32, capacity factor 15); one
    layer's ``moe_ffn`` against ``moe_ffn_dense_ref`` (T = 2048, capacity
    factor 15, fp32); the dispatch on the card bitwise the CPU's on the
    same probs (and on probs rounded to 1/16, full of ties); and the smoke
    config's loss, prefill and decode on the card against the CPU. The
    port's kernels launch no time."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map
    from repro_torch.sharding.rules import ParallelContext

    cfg = get_arch("qwen2-moe-a2.7b").model
    check(cfg.num_layers == 24 and cfg.d_model == 2048
          and cfg.moe.num_experts == 60 and cfg.moe.top_k == 4
          and cfg.vocab_size == 151936, "route p: not qwen2-moe's widths")
    largest = max(leaf_sizes(cfg))
    host = host_available_gb()
    print(f"route p: the host has {host:.1f} GB available, the largest leaf "
          f"is {4 * largest / 1e9:.1f} GB")
    check(host * 1e9 > 1.5 * 4 * largest,
          f"route p: {host:.1f} GB of host memory cannot draw a "
          f"{4 * largest / 1e9:.1f} GB leaf")
    res, params = serve_route("p", cfg, None, MOE_SERVE_RUNS)
    res["host_available_gb"] = host
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # decode against the full-sequence forward, published widths, 2 layers
    ctx = ParallelContext()
    c2 = mreplace(cfg, num_layers=2, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DECODE_CF))
    m2 = Model(c2)
    p2 = m2.init(torch.Generator().manual_seed(1), "cuda")
    P, steps = 96, 8
    dec_err = decode_vs_forward(m2, p2, P, steps, seed=2)
    check(dec_err <= DECODE_TOL, f"route p: prefill + decode differ from "
          f"the full-sequence forward by {dec_err} of the largest logit")
    res["decode_vs_forward_rel_err"] = dec_err
    print(f"route p: prefill + {steps - 1} decode steps vs the full-sequence "
          f"forward (published widths, 2 layers, fp32, capacity factor "
          f"{MOE_DECODE_CF}): max |diff| {dec_err:.3g} of the largest logit "
          f"(tolerance {DECODE_TOL})")

    # one layer's MoE FFN against the dense reference, and the dispatch
    mlp = p2["stack"]["groups"]["l0"]["mlp"]
    mlp = tree_map(lambda t: t[0], mlp)
    del p2
    torch.cuda.empty_cache()
    x = torch.randn(4, 512, cfg.d_model, generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    with torch.no_grad():
        out, aux = moe_mod.moe_ffn(mlp, x, c2.moe, ctx, dtype="float32")
        want = moe_mod.moe_ffn_dense_ref(mlp, x, c2.moe, ctx,
                                         dtype="float32")
        probs = moe_mod.router_probs(mlp, x.reshape(-1, cfg.d_model),
                                     cfg.moe, "float32")
    dense_err = _rel_err(out, want)
    check(dense_err <= MOE_DENSE_TOL and bool(torch.isfinite(aux)),
          f"route p: moe_ffn differs from moe_ffn_dense_ref by {dense_err} "
          f"of the largest value (aux {float(aux)})")
    res["moe_vs_dense_rel_err"] = dense_err
    del out, want, x, mlp
    ties = torch.round(probs * 16) / 16
    for what, pr in (("router", probs), ("ties", ties)):
        on_card = moe_mod.dispatch(pr, cfg.moe)
        on_cpu = moe_mod.dispatch(pr.cpu(), cfg.moe)
        check(on_card.C == on_cpu.C, f"route p: dispatch C {on_card.C} on "
              f"the card, {on_cpu.C} on the CPU")
        for name in ("gates", "top_idx", "sel", "w_tok", "tok_idx", "valid"):
            a, b = getattr(on_card, name).cpu(), getattr(on_cpu, name)
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b), f"route p: the dispatch's {name} on "
                  f"the card differs from the CPU's ({what} probs)")
    res["dispatch_bitwise"] = {"T": probs.shape[0], "C": on_cpu.C}
    print(f"route p: one layer's moe_ffn (T = 2048, capacity factor "
          f"{MOE_DECODE_CF}, fp32) vs moe_ffn_dense_ref: max |diff| "
          f"{dense_err:.3g} of the largest value (tolerance "
          f"{MOE_DENSE_TOL}); the dispatch (T = {probs.shape[0]}, C = "
          f"{on_cpu.C}) on the card equals the CPU's to the bit, on the "
          f"router's probs and on probs rounded to 1/16")
    del probs, ties, on_card
    torch.cuda.empty_cache()

    # the card against the CPU on the smoke config
    card_err = smoke_card_vs_cpu("qwen2-moe-a2.7b")
    check(card_err <= MOE_CARD_TOL, f"route p: the smoke config on the card "
          f"differs from the CPU by {card_err} of the largest value")
    res["card_vs_cpu_rel_err"] = card_err
    print(f"route p: qwen2-moe smoke loss, aux, prefill and 8 decode steps on "
          f"the card vs the CPU: max |diff| {card_err:.3g} of the largest "
          f"value (tolerance {MOE_CARD_TOL})")
    return res


#: route r's cut of deepseek-v3-671b: published widths, 1 of 61 layers,
#: no MTP block (serving never runs it): 13,360,651,264 params, 53.44 GB
#: of fp32 weights (ROADMAP Queue 1 item 8c)
MLA_SERVE_LAYERS = 1
#: decode against the forward at deepseek-v3's widths takes capacity
#: factor 32 = E/k, so that C = T on both paths (decode drops no token the
#: forward keeps)
MLA_DECODE_CF = 32.0
#: route t's check of decode against the forward: recurrentgemma-2b's
#: widths at 5 layers (one period and the 2-layer tail), fp32, a prompt of
#: 2,100 (past the 2,048 window: the ring wraps) and 8 decode steps
RG_DECODE_LAYERS, RG_DECODE_PROMPT = 5, 2100


def route_r() -> dict:
    """Route r: deepseek-v3-671b served at its published widths (MLA with
    its absorbed decode over the latent cache, 256 experts top-8 and a
    shared one), ``MLA_SERVE_LAYERS`` layer and no MTP block, bf16 compute
    on fp32 weights drawn on the card from a seeded CUDA generator (the
    largest leaf is 15.0 GB), through :func:`serve_route`. Then, on the
    same weights in fp32 at capacity factor ``MLA_DECODE_CF``: prefill +
    absorbed decode against the decompressed full-sequence forward; and
    the smoke config (MTP head included) on the card against the CPU."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    full = get_arch("deepseek-v3-671b").model
    cfg = mreplace(full, num_layers=MLA_SERVE_LAYERS, mtp=None)
    m, mo = cfg.mla, cfg.moe
    check(cfg.d_model == 7168 and cfg.num_heads == 128
          and (m.kv_lora_rank, m.q_lora_rank, m.rope_head_dim,
               m.nope_head_dim, m.v_head_dim) == (512, 1536, 64, 128, 128)
          and (mo.num_experts, mo.top_k, mo.d_ff_expert) == (256, 8, 2048)
          and cfg.vocab_size == 129280, "route r: not deepseek-v3's widths")
    res, params = serve_route("r", cfg, torch.Generator(
        device="cuda").manual_seed(0))
    res["reduced"] = {"num_layers": [full.num_layers, cfg.num_layers],
                      "mtp": "dropped (serving never runs it)"}

    # decode against the forward on the same weights: fp32, E/k capacity
    m2 = Model(mreplace(cfg, dtype="float32", moe=dataclasses.replace(
        mo, capacity_factor=MLA_DECODE_CF)))
    P, steps = 96, 8
    dec_err = decode_vs_forward(m2, params, P, steps, seed=2)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    check(dec_err <= DECODE_TOL, f"route r: prefill + absorbed decode "
          f"differ from the forward by {dec_err} of the largest logit")
    res["decode_vs_forward_rel_err"] = dec_err
    print(f"route r: prefill + {steps - 1} absorbed decode steps vs the "
          f"decompressed full-sequence forward (published widths, "
          f"{cfg.num_layers} layer, fp32, capacity factor {MLA_DECODE_CF}): "
          f"max |diff| {dec_err:.3g} of the largest logit (tolerance "
          f"{DECODE_TOL})")

    card_err = smoke_card_vs_cpu("deepseek-v3-671b", chunk=16)
    check(card_err <= CARD_TOL, f"route r: the smoke config on the card "
          f"differs from the CPU by {card_err} of the largest value")
    res["card_vs_cpu_rel_err"] = card_err
    print(f"route r: deepseek-v3 smoke loss, ce, aux, mtp_ce, prefill (four "
          f"MLA q-chunks) and 8 "
          f"decode steps on the card vs the CPU: max |diff| {card_err:.3g} "
          f"of the largest value (tolerance {CARD_TOL})")
    return res


def route_t() -> dict:
    """Route t: recurrentgemma-2b served at its published widths and full
    depth (26 layers: (RG-LRU, RG-LRU, local attention) × 8 and two RG-LRU
    layers, bf16 compute on fp32 weights from
    ``torch.Generator().manual_seed(0)``) through :func:`serve_route`: the
    4,608-token prompt is past the 2,048 window, so the attention rings
    wrap while the RG-LRU state carries. Then decode against the
    full-sequence forward at ``RG_DECODE_LAYERS`` layers, fp32, past the
    window; and the smoke config on the card against the CPU."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model

    cfg = get_arch("recurrentgemma-2b").model
    check(cfg.num_layers == 26 and cfg.d_model == 2560
          and cfg.rglru.lru_width == 2560 and cfg.sliding_window == 2048
          and cfg.vocab_size == 256000, "route t: not recurrentgemma's widths")
    res, params = serve_route("t", cfg, None)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    m5 = Model(mreplace(cfg, num_layers=RG_DECODE_LAYERS, dtype="float32"))
    p5 = m5.init(torch.Generator(device="cuda").manual_seed(1), "cuda")
    steps = 8
    dec_err = decode_vs_forward(m5, p5, RG_DECODE_PROMPT, steps, seed=2)
    del p5
    torch.cuda.empty_cache()
    check(dec_err <= DECODE_TOL, f"route t: prefill + decode differ from "
          f"the full-sequence forward by {dec_err} of the largest logit")
    res["decode_vs_forward_rel_err"] = dec_err
    print(f"route t: prefill of {RG_DECODE_PROMPT} + {steps - 1} decode steps "
          f"vs the full-sequence forward (published widths, "
          f"{RG_DECODE_LAYERS} layers, fp32, the rings wrapped): max |diff| "
          f"{dec_err:.3g} of the largest logit (tolerance {DECODE_TOL})")

    card_err = smoke_card_vs_cpu("recurrentgemma-2b", chunk=16)
    check(card_err <= CARD_TOL, f"route t: the smoke config on the card "
          f"differs from the CPU by {card_err} of the largest value")
    res["card_vs_cpu_rel_err"] = card_err
    print(f"route t: recurrentgemma smoke loss, prefill (chunked, banded) and "
          f"8 decode steps on the card vs the CPU: max |diff| {card_err:.3g} "
          f"of the largest value (tolerance {CARD_TOL})")
    return res


def lm_fed(dp: int = LM_CLIENTS):
    """Route o's (q's, at ``dp`` 1) ``FedConfig``: the train CLI's
    (``launch/train.py --dp 2 --compressor topk --aggregation sparse``,
    every other flag at its default: fedcams, ratio 1/64, K = 2, η = 0.5,
    η_l = 0.05)."""
    from repro_torch.launch import train as ttrain
    ap = ttrain.parser()
    return ttrain.build_fed(ap.parse_args(
        ["--dp", str(dp), "--compressor", "topk", "--aggregation",
         "sparse"]), ap)


def _recording_metrics(names, sink: dict):
    """Make ``Model.loss`` (in this process) also append each call's
    ``metrics[name]`` for each of ``names`` to ``sink[name]``: the mesh
    round reports the loss, and the aux loss and the MTP head's cross
    entropy are parts of it."""
    from repro_torch.models.model import Model
    loss = Model.loss

    def recorded(self, *a, **kw):
        out = loss(self, *a, **kw)
        for name in names:
            sink.setdefault(name, []).append(out[1][name].detach())
        return out

    Model.loss = recorded


@contextlib.contextmanager
def _recording_state(sink: dict):
    """Each round body that ``core.mesh.build_fed_round`` builds (in this
    process) leaves its last state in ``sink["state"]`` and its context's
    model index in ``sink["model_index"]``."""
    from repro_torch.core import mesh as meshmod
    build = meshmod.build_fed_round

    def recorded(model, fed, train, ctx, **kw):
        rnd = build(model, fed, train, ctx, **kw)
        sink["model_index"] = ctx.model_index()

        def fed_round(state, batch, seed):
            out = rnd(state, batch, seed)
            sink["state"] = out[0]
            return out

        return fed_round

    meshmod.build_fed_round = recorded
    try:
        yield
    finally:
        meshmod.build_fed_round = build


def _leaf_digests(tree) -> dict:
    """Each leaf's path → the SHA-256 of its bytes."""
    from repro_torch.models.params import leaves_with_paths
    return {"/".join(p): hashlib.sha256(t.detach().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for p, t in leaves_with_paths(tree)}


def _lm_job(job: dict) -> dict:
    """One rank of route o, q, s, u or w: the launch counters at 0, then
    ``launch/train.py``'s ``train`` (model at ``job["tp"]``, state, data
    and rounds, on ``job["device"]``, default the card; with
    ``job["keep_params"]`` the gathered params back), then the counters
    read (and every local step's metrics named in ``job["metrics"]``; with
    ``job["digests"]`` each leaf's digest of this rank's final params, m, v
    and v̂, and its model index)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    sink, state = {}, {}
    device = job.get("device", "cuda")
    _recording_metrics(job.get("metrics", ()), sink)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launches()
    with contextlib.ExitStack() as stack:
        if job.get("digests"):
            stack.enter_context(_recording_state(state))
        out = ttrain.train(job["cfg"], job["fed"], job["train"],
                           device=device, tp=job.get("tp", 1),
                           keep_params=job.get("keep_params", False))
    out["launches"] = dict(ops.launches)
    out["metrics"] = {k: [float(v) for v in vs] for k, vs in sink.items()}
    if job.get("digests"):
        st = state.pop("state")
        out["model_index"] = state["model_index"]
        out["digests"] = {f: _leaf_digests(getattr(st, f))
                          for f in ("params", "m", "v", "vhat")}
        del st
    return out


@contextlib.contextmanager
def expandable_segments():
    """The ranks' allocator grows its segments in place (less memory
    stranded between the round's phases' large blocks)."""
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved


def lm_memory_reckoning(cfg, d: int, largest: int, tokens: int,
                        seq: int = 512) -> dict:
    """What a rank of route o holds at its peak, reckoned from the shapes
    (bytes; a "copy" is the (d,) fp32 vector). Always: the state (params,
    m, v, v̂ and the rank's EF row, 5 copies). In local training: the flat
    params and the local iterate (2), the gradient and the per-leaf
    gradients it is cut from (2), and the logits' temporaries — about six
    fp32 (tokens, vocab) tensors a head (two with the MTP head), the bf16
    table and its bf16 gradient — and, a recurrent layer, the scan's saved
    levels (about 16 fp32 (tokens, width) tensors; an sLSTM layer its
    steps', an mLSTM layer its (tokens, seq, heads) scores). In the server
    step: the delta and the new EF row (2), the new params, m, v, v̂ built
    leaf by leaf (4), and the largest leaf's EF copy."""
    copy = 4 * d
    heads = 1 if cfg.mtp is None else 2
    acts = (heads * 6 * tokens * cfg.vocab_size * 4
            + 2 * 2 * cfg.vocab_size * cfg.d_model)
    if cfg.rglru is not None:
        acts += (cfg.layer_kinds.count("rglru") * 16 * tokens
                 * (cfg.rglru.lru_width or cfg.d_model) * 4)
    if cfg.xlstm is not None:
        # the sLSTM's ~30 fp32 (tokens, d) step tensors saved a layer, the
        # mLSTM's ~6 fp32 (tokens, seq, heads) score tensors a layer
        acts += (cfg.layer_kinds.count("slstm") * 30 * tokens * cfg.d_model
                 * 4 + cfg.layer_kinds.count("mlstm") * 6 * tokens * seq
                 * cfg.num_heads * 4)
    local = 9 * copy + acts
    server = 11 * copy + 4 * largest
    return {"copy_gb": copy / 1e9, "state_gb": 5 * copy / 1e9,
            "local_phase_gb": local / 1e9, "server_phase_gb": server / 1e9,
            "per_rank_gb": max(local, server) / 1e9}


def route_o(held) -> dict:
    """Route o: federated LM training through ``launch/train.py``'s
    ``train`` on gemma2-2b at published widths and ``LM_LAYERS`` layers,
    ``LM_CLIENTS`` gloo ranks sharing the card (one client each), fedcams
    with blockwise top-k 1/64 over the sparse collective and the fused
    ingest through ``KernelImpl``, K = 2, per-client batch 2 × seq 512,
    ``LM_ROUNDS`` rounds. Each rank launches ``topk_ef_sparse`` and
    ``fedams_ingest`` once a leaf a round, at shapes phase 1 held;
    ``wire_up_bytes`` is what ``mesh_wire_bytes_tiers`` bills; losses and
    state finite."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.mesh import mesh_wire_bytes_tiers
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, tree_leaves

    cfg, fed = lm_cfg(), lm_fed()
    model = Model(cfg)
    leaves = len(tree_leaves(model.defs()))
    d = count_params(model.defs())
    train = TrainConfig(global_batch=2 * LM_CLIENTS, seq_len=512,
                        rounds=LM_ROUNDS, remat_policy="none")
    largest = max(int(np.prod(dref.shape)) for dref in
                  tree_leaves(model.defs()))
    plan = lm_memory_reckoning(cfg, d, largest,
                               train.global_batch // LM_CLIENTS
                               * train.seq_len)
    free, total = torch.cuda.mem_get_info()
    print(f"route o: d = {d:,} ({leaves} leaves); a rank holds "
          f"~{plan['per_rank_gb']:.1f} GB at its peak (reckoned: {plan}); "
          f"{LM_CLIENTS} ranks on a card with {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free")
    check(LM_CLIENTS * plan["per_rank_gb"] * 1e9 < free,
          f"route o: {LM_CLIENTS} ranks do not fit the card: {plan}")
    with expandable_segments():
        ranks = run_ranks(LM_CLIENTS, "gloo", {"o": dict(
            cfg=cfg, fed=fed, train=train)}, fn=_lm_job, timeout=900,
            record=True)
    rs = [rk["o"] for rk in ranks]
    n_shapes = check_shapes_held("o", rs, held)
    want = {"topk_ef_sparse": leaves * LM_ROUNDS,
            "fedams_ingest": leaves * LM_ROUNDS}
    for i, r in enumerate(rs):
        got = {k: v for k, v in r["launches"].items() if v}
        check(got == want, f"route o rank {i}: launches {got}, expected "
              f"{want} ({leaves} leaves a round)")
    tiers = mesh_wire_bytes_tiers(fed, model.defs())
    expected = float(np.float32(fed.num_clients * tiers["tier1"]))
    hist = [[h for h in r["history"]] for r in rs]
    losses = [h["loss"] for h in hist[0]]
    check(all([h["loss"] for h in hr] == losses for hr in hist),
          "route o: the ranks' losses differ")
    check(all(np.isfinite(losses)) and all(r["finite"] for r in rs),
          f"route o: losses {losses} or a non-finite state")
    wire = [h["wire_up_bytes"] for h in hist[0]]
    check(wire == [expected] * LM_ROUNDS, f"route o: wire_up_bytes {wire}, "
          f"mesh_wire_bytes_tiers bills {expected}")
    round_ms = [h["round_s"] * 1e3 for h in hist[0]]
    peaks = [r["peak_bytes"] / 1e9 for r in rs]
    print(f"route o: gemma2-2b at published widths, {LM_LAYERS} layers, "
          f"{rs[0]['params']:,} params, {LM_CLIENTS} gloo ranks: losses {losses}; "
          f"wire_up_bytes {wire[0]:.0f} a round (tiers {tiers}); launches a "
          f"round, each rank {leaves} topk_ef_sparse + {leaves} "
          f"fedams_ingest; round ms (rank 0) {[round(t, 1) for t in round_ms]}"
          f"; peak memory a rank {[round(p, 2) for p in peaks]} GB; distinct "
          f"launch shapes, each held by phase 1: {n_shapes}")
    return {"losses": losses, "wire_up_bytes": wire, "tiers": tiers,
            "round_ms": round_ms, "peak_gb": peaks, "reckoned": plan,
            "d": d, "leaves": leaves, "shapes_held": n_shapes,
            "launches": {k: sum(r["launches"][k] for r in rs)
                         for k in rs[0]["launches"]}}


def route_one_rank(route: str, cfg, rounds: int, held,
                   positive=()) -> dict:
    """Federated training through ``launch/train.py``'s ``train`` on
    ``cfg`` (published widths, depth and the rest cut as the route says),
    one NCCL rank (one client: one rank of these fills most of the card),
    fedcams with blockwise top-k 1/64 over the sparse collective and the
    fused ingest through ``KernelImpl``, K = 2, batch 2 × seq 512,
    ``rounds`` rounds. The rank launches ``topk_ef_sparse`` and
    ``fedams_ingest`` once a leaf a round, at shapes phase 1 held;
    ``wire_up_bytes`` is what ``mesh_wire_bytes_tiers`` bills; losses and
    state finite; every local step's metrics in ``positive`` finite and
    > 0."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.mesh import mesh_wire_bytes_tiers
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, tree_leaves

    fed = lm_fed(dp=1)
    model = Model(cfg)
    leaves = len(tree_leaves(model.defs()))
    d = count_params(model.defs())
    train = TrainConfig(global_batch=2, seq_len=512, rounds=rounds,
                        remat_policy="none")
    plan = lm_memory_reckoning(cfg, d, max(leaf_sizes(cfg)),
                               train.global_batch * train.seq_len)
    free, total = torch.cuda.mem_get_info()
    print(f"route {route}: {cfg.name} at published widths, {cfg.num_layers} "
          f"layer(s): d = {d:,} ({leaves} leaves); a rank holds "
          f"~{plan['per_rank_gb']:.1f} GB at its peak (reckoned: {plan}), so "
          f"2 ranks would need {2 * plan['per_rank_gb']:.1f} of the card's "
          f"{total / 1e9:.1f} GB; 1 rank on {free / 1e9:.1f} GB free")
    check(plan["per_rank_gb"] * 1e9 < free,
          f"route {route}: one rank does not fit the card: {plan}")
    with expandable_segments():
        r = run_ranks(1, "nccl", {route: dict(cfg=cfg, fed=fed, train=train,
                                              metrics=positive)},
                      fn=_lm_job, timeout=900, record=True)[0][route]
    n_shapes = check_shapes_held(route, [r], held)
    want = {"topk_ef_sparse": leaves * rounds, "fedams_ingest": leaves * rounds}
    got = {k: v for k, v in r["launches"].items() if v}
    check(got == want, f"route {route}: launches {got}, expected {want} "
          f"({leaves} leaves a round)")
    tiers = mesh_wire_bytes_tiers(fed, model.defs())
    expected = float(np.float32(fed.num_clients * tiers["tier1"]))
    losses = [h["loss"] for h in r["history"]]
    check(all(np.isfinite(losses)) and r["finite"],
          f"route {route}: losses {losses} or a non-finite state")
    for name in positive:
        vals = r["metrics"][name]
        check(len(vals) == rounds * fed.local_steps and all(
            np.isfinite(vals)) and min(vals) > 0,
            f"route {route}: the local steps' {name} {vals}")
    wire = [h["wire_up_bytes"] for h in r["history"]]
    check(wire == [expected] * rounds, f"route {route}: wire_up_bytes "
          f"{wire}, mesh_wire_bytes_tiers bills {expected}")
    round_ms = [h["round_s"] * 1e3 for h in r["history"]]
    peak = r["peak_bytes"] / 1e9
    print(f"route {route}: {cfg.name}, {r['params']:,} params, 1 NCCL rank: "
          f"losses {losses}; local steps' {r['metrics']}; wire_up_bytes "
          f"{wire[0]:.0f} a round (tiers {tiers}); launches a round {leaves} "
          f"topk_ef_sparse + {leaves} fedams_ingest; round ms "
          f"{[round(t, 1) for t in round_ms]}; peak memory {peak:.2f} GB "
          f"(reckoned {plan['per_rank_gb']:.2f}); distinct launch shapes, "
          f"each held by phase 1: {n_shapes}")
    return {"losses": losses, "metrics": r["metrics"], "wire_up_bytes": wire,
            "tiers": tiers, "round_ms": round_ms, "peak_gb": peak,
            "reckoned": plan, "d": d, "leaves": leaves,
            "shapes_held": n_shapes, "launches": r["launches"]}


def route_q(held) -> dict:
    """Route q: qwen2-moe-a2.7b at published widths and ``MOE_LAYERS``
    layer (~53.7 GB a rank, so two do not fit the card) through
    :func:`route_one_rank`; every local step's aux loss > 0."""
    return route_one_rank("q", moe_cfg(), MOE_ROUNDS, held,
                          positive=("aux",))


def route_s(held) -> dict:
    """Route s: deepseek-v3-671b at published d_model, heads and MLA dims
    with its MTP block, cut as :func:`mla_train_cfg` says, through
    :func:`route_one_rank`; every local step's aux loss and MTP cross
    entropy > 0."""
    return route_one_rank("s", mla_train_cfg(), MLA_ROUNDS, held,
                          positive=("aux", "mtp_ce"))


def route_u(held) -> dict:
    """Route u: recurrentgemma-2b at published widths, ``RG_LAYERS``
    layers (one period and the 2-layer tail), through
    :func:`route_one_rank`."""
    return route_one_rank("u", rg_train_cfg(), RG_ROUNDS, held)


#: route v's runs through launch/serve.py: (batch, prompt, gen, q-chunk);
#: the 4,608-token prompt is two mLSTM q-chunks of 2,304 at chunk 2048,
#: and each sLSTM layer steps 4,608 times
XLSTM_SERVE_RUNS = ((4, 512, 32, 2048), (1, 4608, 16, 2048))
#: route v's decode against the forward: xlstm-350m's widths at 4 layers,
#: fp32, a prompt of 96 and 8 decode steps
XLSTM_DECODE_LAYERS = 4


def route_v() -> dict:
    """Route v: xlstm-350m served at its published widths and depth (24
    layers alternating mLSTM and sLSTM, d_model 1024, 4 heads, the mLSTM 2048
    wide, vocabulary 50,304; 343,856,128 params, bf16 compute on fp32
    weights drawn on the card) through :func:`serve_route`: batch 4 × 512 +
    32, then 1 × 4,608 + 16 (two mLSTM q-chunks of 2,304; the sLSTM state
    carried over 4,608 sequential steps). Then decode against the
    full-sequence forward at ``XLSTM_DECODE_LAYERS`` layers, fp32; and the
    smoke config on the card against the CPU."""
    from repro_torch.configs.base import mreplace
    from repro_torch.models.model import Model

    cfg = xlstm_cfg()
    check(cfg.num_layers == 24 and cfg.d_model == 1024 and cfg.num_heads == 4
          and cfg.vocab_size == 50304 and cfg.xlstm.mlstm_proj_factor == 2.0
          and cfg.layer_kinds[:2] == ("mlstm", "slstm")
          and cfg.dtype == "bfloat16", "route v: not xlstm-350m's widths")
    res, params = serve_route("v", cfg, torch.Generator(
        device="cuda").manual_seed(0), runs=XLSTM_SERVE_RUNS)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    m4 = Model(mreplace(cfg, num_layers=XLSTM_DECODE_LAYERS,
                        dtype="float32"))
    p4 = m4.init(torch.Generator(device="cuda").manual_seed(1), "cuda")
    P, steps = 96, 8
    dec_err = decode_vs_forward(m4, p4, P, steps, seed=2)
    del p4
    torch.cuda.empty_cache()
    check(dec_err <= DECODE_TOL, f"route v: prefill + decode differ from "
          f"the full-sequence forward by {dec_err} of the largest logit")
    res["decode_vs_forward_rel_err"] = dec_err
    print(f"route v: prefill of {P} + {steps - 1} decode steps vs the "
          f"full-sequence forward (published widths, {XLSTM_DECODE_LAYERS} "
          f"layers, fp32): max |diff| {dec_err:.3g} of the largest logit "
          f"(tolerance {DECODE_TOL})")

    card_err = smoke_card_vs_cpu("xlstm-350m", chunk=16)
    check(card_err <= CARD_TOL, f"route v: the smoke config on the card "
          f"differs from the CPU by {card_err} of the largest value")
    res["card_vs_cpu_rel_err"] = card_err
    print(f"route v: xlstm smoke loss, prefill (three mLSTM q-chunks) and 8 "
          f"decode steps on the card vs the CPU: max |diff| {card_err:.3g} "
          f"of the largest value (tolerance {CARD_TOL})")
    return res


#: route w's pairs: dense FedAvg rounds in fp32 (no kernel: a blockwise
#: top-k selects from each rank's model-local leaf, so only a dense round
#: is the same at tp 1 and 2) from the same seeded init, dp 2 × tp 2
#: against dp 2 × tp 1. At one local step the loss within W_LOSS_RTOL
#: relative and each gathered leaf of the params within W_PARAMS_TOL of
#: its largest |value|. At route w's own K = 2 the loss within
#: W_LOSS_RTOL, and each leaf within W_WITNESS_FACTOR times what the same
#: tp 1 round reads on the card against the host's CPU (other kernels,
#: other orders of sums), or W_PARAMS_TOL where that is more. The round is
#: ill-conditioned at K = 2 (ROADMAP Queue 3 item 29): the zero-initialised
#: sLSTM bias, all update, read 1.05 at tp 1 card against CPU, and tp 2
#: against tp 1 3.2e-4 at one local step and 0.50 at two; no leaf of tp
#: 2's over 1.2 times its witness (H100 80GB HBM3, 700.00 W)
W_LOSS_RTOL, W_PARAMS_TOL, W_WITNESS_FACTOR = 1e-4, 1e-3, 10.0


def _w_jobs(tp: int, device: str = "cuda"):
    """Route w's jobs at ``tp``: at W_TP the main run (fedcams, blockwise
    top-k 1/64 over the sparse collective, fused ingest, K = 2, batch 2 ×
    512 a client, η ``W_ETA``, η_l ``W_ETA_L``, W_ROUNDS rounds), then the
    FedAvg rounds at one and at two local steps (the same η_l), each
    keeping its ranks' digests; at 1 the two FedAvg rounds, on the CPU the
    second alone."""
    from repro_torch.configs.base import TrainConfig, mreplace
    cfg = xlstm_cfg()
    train = TrainConfig(global_batch=2 * W_DP, seq_len=512, rounds=W_ROUNDS,
                        remat_policy="none")
    avg = dataclasses.replace(w_fed(), algorithm="fedavg",
                              compressor="none", aggregation="dense")
    pair = dict(cfg=mreplace(cfg, dtype="float32"),
                train=dataclasses.replace(train, rounds=1), tp=tp,
                keep_params=True, digests=tp > 1, device=device)
    jobs = {f"avg{k}": dict(pair, fed=dataclasses.replace(avg, local_steps=k))
            for k in ((2,) if device == "cpu" else (1, 2))}
    if tp > 1:
        return {"w": dict(cfg=cfg, fed=w_fed(), train=train, tp=tp,
                          digests=True), **jobs}
    return jobs


def _leaf_errs(got, want) -> dict:
    """Each leaf's path → max |got − want| over the largest |want|."""
    from repro_torch.models.params import leaves_with_paths
    ref = dict(leaves_with_paths(want))
    return {"/".join(p): float((t - ref[p]).abs().max()
                               / ref[p].abs().max().clamp_min(1e-30))
            for p, t in leaves_with_paths(got)}


def _worst(errs: dict, n: int = 4) -> list:
    return sorted(((e, k) for k, e in errs.items()), reverse=True)[:n]


def check_replicas(route: str, ranks: list, defs, tp: int) -> int:
    """Every rank's final params, m, v and v̂ (``_lm_job``'s digests): a
    leaf that no dim shards over the model axis the same to the bit on
    every rank, a model-sharded leaf on every rank of its model index.
    Returns the count of replicated leaves."""
    from repro_torch.models.params import dim_axes, leaves_with_paths
    reps = {"/".join(p) for p, d in leaves_with_paths(defs)
            if not any("model" in dim_axes(sp) for sp in d.dim_specs)}
    check({r["model_index"] for r in ranks} == set(range(tp)),
          f"route {route}: model indices {[r['model_index'] for r in ranks]}")
    for f in ("params", "m", "v", "vhat"):
        for leaf, d0 in ranks[0]["digests"][f].items():
            peers = [r for r in ranks if leaf in reps
                     or r["model_index"] == ranks[0]["model_index"]]
            check(all(r["digests"][f][leaf] == d0 for r in peers),
                  f"route {route}: {f} {leaf} differs across ranks that "
                  f"hold the same copy of it")
    return len(reps)


def route_w(held) -> dict:
    """Route w: xlstm-350m at its published widths and depth trained
    through ``launch/train.py``'s ``train`` on dp ``W_DP`` × tp ``W_TP``:
    four gloo ranks sharing the card, each holding its model shards.
    fedcams with blockwise top-k 1/64 over the sparse collective and the
    fused ingest, K = 2, batch 2 × 512 a client, η ``W_ETA``, η_l
    ``W_ETA_L``, ``W_ROUNDS`` rounds: each rank launches ``topk_ef_sparse``
    and ``fedams_ingest`` once a model-local leaf a round, at shapes phase
    1 held; ``wire_up_bytes`` as ``mesh_wire_bytes_tiers`` bills the local
    leaves × tp; losses and state finite; every replicated leaf of the
    final state the same on all four ranks. Then dense FedAvg rounds in
    fp32 at one and at two local steps on the same ranks and on dp 2 × tp
    1 (two ranks), from the same seeded init, and the second on dp 2 × tp
    1 on the host's CPU, held as the constants above say."""
    from repro_torch.core.mesh import mesh_wire_bytes_tiers
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, local_shape, \
        tree_leaves, tree_map

    cfg, fed = xlstm_cfg(), w_fed()
    model = Model(cfg, tp=W_TP)
    local = tree_map(lambda d: dataclasses.replace(
        d, shape=local_shape(d, {"model": W_TP})), model.defs())
    leaves = len(tree_leaves(local))
    d_all, d = count_params(model.defs()), count_params(local)
    plan = lm_memory_reckoning(cfg, d, max(leaf_sizes(cfg, W_TP)), 512)
    world = W_DP * W_TP
    free, total = torch.cuda.mem_get_info()
    print(f"route w: {cfg.name}, {d_all:,} params in {leaves} leaves; a "
          f"rank at tp {W_TP} holds {d:,} (its model shards); reckoned "
          f"~{plan['per_rank_gb']:.1f} GB a rank at its peak ({plan}); "
          f"{world} ranks on a card with {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free")
    check(world * plan["per_rank_gb"] * 1e9 < free,
          f"route w: {world} ranks do not fit the card: {plan}")
    with expandable_segments():
        ranks = run_ranks(world, "gloo", _w_jobs(W_TP), fn=_lm_job,
                          timeout=900, record=True)
    rs = [rk["w"] for rk in ranks]
    n_shapes = check_shapes_held("w", rs, held)
    want = {"topk_ef_sparse": leaves * W_ROUNDS,
            "fedams_ingest": leaves * W_ROUNDS}
    for i, r in enumerate(rs):
        got = {k: v for k, v in r["launches"].items() if v}
        check(got == want, f"route w rank {i}: launches {got}, expected "
              f"{want} ({leaves} model-local leaves a round)")
        for k in ("avg1", "avg2"):
            check(not any(ranks[i][k]["launches"].values()),
                  f"route w rank {i}: the FedAvg round {k} launched "
                  f"{ranks[i][k]['launches']}")
    n_rep = check_replicas("w", rs, model.defs(), W_TP)
    for k in ("avg1", "avg2"):
        check_replicas(f"w ({k})", [rk[k] for rk in ranks], model.defs(),
                       W_TP)
    tiers = mesh_wire_bytes_tiers(fed, local, tp=W_TP)
    expected = float(np.float32(fed.num_clients * tiers["tier1"]))
    hist = [r["history"] for r in rs]
    losses = [h["loss"] for h in hist[0]]
    check(all([h["loss"] for h in hr] == losses for hr in hist),
          f"route w: the ranks' losses differ: "
          f"{[[h['loss'] for h in hr] for hr in hist]}")
    check(all(np.isfinite(losses)) and all(r["finite"] for r in rs),
          f"route w: losses {losses} or a non-finite state")
    wire = [h["wire_up_bytes"] for h in hist[0]]
    check(wire == [expected] * W_ROUNDS, f"route w: wire_up_bytes {wire}, "
          f"mesh_wire_bytes_tiers bills {expected}")
    round_ms = [h["round_s"] * 1e3 for h in hist[0]]
    peaks = [r["peak_bytes"] / 1e9 for r in rs]

    one = run_ranks(W_DP, "gloo", _w_jobs(1), fn=_lm_job, timeout=900)[0]
    host = run_ranks(W_DP, "gloo", _w_jobs(1, "cpu"), fn=_lm_job,
                     timeout=900)[0]
    pairs = {}
    for k in ("avg1", "avg2"):
        a2, a1 = ranks[0][k], one[k]
        loss2, loss1 = a2["history"][0]["loss"], a1["history"][0]["loss"]
        pairs[k] = {"loss": [loss2, loss1],
                    "loss_rel_err": abs(loss2 - loss1) / abs(loss1),
                    "errs": _leaf_errs(a2["params"], a1["params"])}
    witness = _leaf_errs(host["avg2"]["params"], one["avg2"]["params"])
    w_loss = [host["avg2"]["history"][0]["loss"],
              one["avg2"]["history"][0]["loss"]]
    one_err = pairs["avg1"]
    check(one_err["loss_rel_err"] <= W_LOSS_RTOL
          and max(one_err["errs"].values()) <= W_PARAMS_TOL,
          f"route w: the FedAvg round at one local step, dp {W_DP} x tp "
          f"{W_TP} vs dp {W_DP} x tp 1: loss {one_err['loss']} "
          f"({one_err['loss_rel_err']:.3g}), the worst leaves "
          f"{_worst(one_err['errs'])}")
    two = pairs["avg2"]
    over = {k: (e, witness[k]) for k, e in two["errs"].items()
            if e > max(W_WITNESS_FACTOR * witness[k], W_PARAMS_TOL)}
    check(two["loss_rel_err"] <= W_LOSS_RTOL and not over,
          f"route w: the FedAvg round at two local steps, dp {W_DP} x tp "
          f"{W_TP} vs dp {W_DP} x tp 1: loss {two['loss']} "
          f"({two['loss_rel_err']:.3g}); leaves over {W_WITNESS_FACTOR} x "
          f"the tp 1 round's card-vs-CPU reading (tp 2, card vs CPU): "
          f"{over}")
    print(f"route w: {cfg.name} at dp {W_DP} x tp {W_TP}, {world} gloo ranks "
          f"sharing the card: losses {losses}; wire_up_bytes {wire[0]:.0f} a "
          f"round (tiers {tiers}); launches a round, each rank {leaves} "
          f"topk_ef_sparse + {leaves} fedams_ingest on its model-local "
          f"leaves; round ms (rank 0) {[round(t, 1) for t in round_ms]}; peak "
          f"memory a rank {[round(p, 2) for p in peaks]} GB (reckoned "
          f"{plan['per_rank_gb']:.2f}); distinct launch shapes, each held by "
          f"phase 1: {n_shapes}; the {n_rep} replicated leaves of params, m, "
          f"v and v̂ the same on all {world} ranks to the bit, the sharded "
          f"ones on each model index's ranks")
    for k, steps in (("avg1", 1), ("avg2", 2)):
        print(f"route w: dense FedAvg round, {steps} local step(s), fp32, "
              f"dp {W_DP} x tp {W_TP} vs dp {W_DP} x tp 1 from the same "
              f"seeded init: loss {pairs[k]['loss']} (rel "
              f"{pairs[k]['loss_rel_err']:.3g}, tolerance {W_LOSS_RTOL}); "
              f"the worst leaves of the gathered params, max |diff| over "
              f"the largest |value|: {_worst(pairs[k]['errs'])}")
    ratio = {k: e / max(witness[k], 1e-30) for k, e in two["errs"].items()}
    print(f"route w: the same tp 1 round at 2 local steps on the host's "
          f"CPU against the card: loss {w_loss}, the worst leaves "
          f"{_worst(witness)}; tp 2's reading over it, the largest ratios "
          f"{_worst(ratio)}")
    return {"losses": losses, "wire_up_bytes": wire, "tiers": tiers,
            "round_ms": round_ms, "peak_gb": peaks, "reckoned": plan,
            "d": d_all, "d_rank": d, "leaves": leaves, "shapes_held": n_shapes,
            "replicated_leaves": n_rep,
            "fedavg_tp2_vs_tp1": pairs,
            "fedavg_tp1_cpu_vs_card": {"loss": w_loss, "errs": witness},
            "fedavg_tp2_over_cpu_witness": ratio,
            "launches": {k: sum(r["launches"][k] for r in rs)
                         for k in rs[0]["launches"]}}


#: route x: gemma2-2b at tp X_TP against route n's tp = 1 on the same
#: weights; the fp32 pairs (a batch of 2 × 96) within X_FP32_TOL of the
#: largest logit at 2 layers, X_FP32_FULL_TOL at all 26 (tp 2 sums each
#: layer's sharded matmuls in two halves, tp 1 in one: 9.79e-6 read at 2
#: layers, H100 80GB HBM3, 700.00 W)
X_TP, X_FP32_TOL, X_FP32_FULL_TOL = 2, 1e-4, 1e-3
#: route x's MoE: qwen2-moe-a2.7b at published widths, 2 layers, tp 4, cut
#: to 58 of its 60 experts so that tp 4 pads them to 60 (60 = 4 · 15 needs
#: no pad; 58 needs two, on the last rank), fp32, capacity factor 15 = E/k
#: (decode drops no token the forward keeps)
X_MOE_TP, X_MOE_LAYERS, X_MOE_EXPERTS, X_MOE_CF = 4, 2, 58, 15.0
#: route x's sequence-sharded decode: gemma2-2b's widths, 2 layers, fp32,
#: 24 tokens into a cache of 32 slots split over 2 ranks of "data"
X_SEQ_SHARDS, X_SEQ_TOL = 2, 1e-5


def _x_serve_job(job: dict) -> dict:
    """One of route x's two ranks: ``launch/serve.py``'s ``serve`` at tp
    ``X_TP`` in this rank (its context over a ("model",) mesh) on each of
    ``job["runs"]`` (a config, batch, prompt, gen, the CUDA generator's
    seed); returns each run's gathered prefill logits, tokens and times."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    ops.reset_launches()
    ctx = tserve.model_context(X_TP, "cuda")
    out = {}
    for name, (cfg, batch, prompt, gen, seed) in job["runs"].items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = tserve.serve(cfg, batch=batch, prompt_len=prompt, gen=gen,
                           tp=X_TP, device="cuda", ctx=ctx,
                           generator=torch.Generator(
                               device="cuda").manual_seed(seed),
                           log=print if name == "full" and
                           ctx.model_index() == 0 else None)
        res.pop("params")
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = res
        gc.collect()
    out["launches"] = dict(ops.launches)
    return out


def _x_mesh_job(job: dict) -> dict:
    """One of route x's four ranks: (1) the MoE cut at tp ``X_MOE_TP``
    (weights drawn on the card, this rank's shards kept): prefill + decode
    against the forward, every dispatch's top-k recorded (no pad expert
    chosen, the pad experts' router probs 0); (2) the sequence-sharded
    decode over ``X_SEQ_SHARDS`` ranks of "data" (the "model" dim's ranks
    repeat it) against the unsharded decode."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import ParallelContext

    ops.reset_launches()
    seen = {"top": -1, "pad_prob": 0.0, "calls": 0}
    dispatch = moe_mod.dispatch

    def recorded(probs, mo, *a, **kw):
        r = dispatch(probs, mo, *a, **kw)
        seen["top"] = max(seen["top"], int(r.top_idx.max()))
        seen["pad_prob"] = max(seen["pad_prob"], float(
            probs[:, mo.num_experts:].max()))
        seen["calls"] += 1
        return r

    moe_mod.dispatch = recorded
    ctx = tserve.model_context(X_MOE_TP, "cuda")
    model = Model(job["moe_cfg"], tp=X_MOE_TP)
    params = model.init(torch.Generator(device="cuda").manual_seed(5),
                        "cuda", ctx=ctx)
    E_loc = tuple(params["stack"]["groups"]["l0"]["mlp"]["w_up"].shape)
    moe_err = decode_vs_forward(model, params, 64, 8, seed=6, ctx=ctx)
    moe_mod.dispatch = dispatch
    del params
    torch.cuda.empty_cache()

    mesh = make_mesh((X_SEQ_SHARDS, X_MOE_TP // X_SEQ_SHARDS),
                     ("data", "model"), "cuda")
    seq = ParallelContext(seq_axis="data", mesh=mesh)
    check(seq.seq_shards == X_SEQ_SHARDS,
          f"route x: the sequence axis has {seq.seq_shards} ranks")
    m2 = Model(job["seq_cfg"])
    p2 = m2.init(torch.Generator(device="cuda").manual_seed(7), "cuda")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, m2.cfg.vocab_size, size=(2, 24)).astype(np.int32)).cuda()
    logits = {}
    with torch.no_grad():
        for tag, c in (("ref", ParallelContext()), ("seq", seq)):
            caches = m2.init_cache(2, 32, seq_sharded=tag == "seq",
                                   device="cuda", ctx=c)
            if tag == "seq":
                slots = caches["groups"]["l1"]["k"].shape[2]
            out = []
            for i in range(24):
                lg, caches = m2.decode_step(p2, toks[:, i:i + 1], caches, i,
                                            c, max_len=32)
                out.append(lg)
            logits[tag] = torch.stack(out, 1)
    return {"moe_decode_vs_forward": moe_err, "moe_w_up_local": E_loc,
            "dispatch": seen, "seq_slots_a_rank": slots,
            "seq_vs_unsharded": _rel_err(logits["seq"], logits["ref"]),
            "launches": dict(ops.launches)}


def route_x() -> dict:
    """Route x: the model axis on the card. (1) gemma2-2b served at its
    published widths and depth at tp ``X_TP`` on two gloo ranks sharing the
    card (``launch/serve.py``'s ``serve`` in each rank, the weights route n
    drew, each rank keeping its shards): batch 4 × 512 + 32, its prefill
    logits against route n's tp = 1 logits (bf16: the largest difference and
    the share of greedy tokens that agree are printed); and in fp32 (batch
    2 × 96 + 2) against the same model at tp = 1 in this process: at 2
    layers within ``X_FP32_TOL``, at all 26 within ``X_FP32_FULL_TOL``. (2) On four gloo ranks:
    qwen2-moe-a2.7b at published widths, ``X_MOE_LAYERS`` layers, tp
    ``X_MOE_TP`` with ``X_MOE_EXPERTS`` experts padded to 60 (no pad expert
    selected; decode = forward within ``DECODE_TOL``, fp32), then a
    sequence-sharded decode over ``X_SEQ_SHARDS`` ranks against the
    unsharded decode within ``X_SEQ_TOL``. The port's kernels launch no
    time."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.models.model import Model

    cfg = get_arch("gemma2-2b").model
    small = mreplace(cfg, num_layers=2, dtype="float32")
    deep = mreplace(cfg, dtype="float32")
    check("n" in SERVED, "route x: route n's logits are not there")
    refs = {}
    for name, c, seed in (("fp32", small, 1), ("fp32_full", deep, 3)):
        m1 = Model(c)
        p1 = m1.init(torch.Generator(device="cuda").manual_seed(seed),
                     "cuda")
        refs[name] = tserve.generate(m1, p1, np.random.default_rng(
            0).integers(0, c.vocab_size, size=(2, 96)).astype(np.int32), 2,
            log=None)["logits0"]
        del p1
        torch.cuda.empty_cache()
    ops.reset_launches()
    rk = run_ranks(X_TP, "gloo", {"x": {"runs": {
        "full": (cfg, 4, 512, 32, 0), "fp32": (small, 2, 96, 2, 1),
        "fp32_full": (deep, 2, 96, 2, 3)}}},
        fn=_x_serve_job, timeout=900)
    full, fp32 = rk[0]["x"]["full"], rk[0]["x"]["fp32"]
    n_logits, n_tokens = SERVED["n"]
    full_err = _rel_err(full["logits0"], n_logits)
    agree = float((full["tokens"] == n_tokens).mean())
    fp32_err = _rel_err(fp32["logits0"], refs["fp32"])
    deep_err = _rel_err(rk[0]["x"]["fp32_full"]["logits0"],
                        refs["fp32_full"])
    summary = _serve_summary(full, 4, 32, max(r["x"]["full"]["peak_gb"]
                                             for r in rk) * 1e9,
                             cfg.vocab_size)
    check(summary["tokens_in_range"] and summary["finite"],
          f"route x: tokens out of range or logits not finite: {summary}")
    check(fp32_err <= X_FP32_TOL, f"route x: fp32 prefill at tp {X_TP} "
          f"differs from tp 1 by {fp32_err} of the largest logit")
    check(deep_err <= X_FP32_FULL_TOL, f"route x: fp32 prefill at tp "
          f"{X_TP}, 26 layers, differs from tp 1 by {deep_err} of the "
          f"largest logit")
    print(f"route x: gemma2-2b at tp {X_TP} (26 layers, bf16), batch 4 × 512 "
          f"+ 32: prefill {summary['prefill_ms']:.1f} ms, decode "
          f"{summary['decode_ms_per_token']:.2f} ms/token, "
          f"{summary['tokens_per_s']:.1f} tok/s, peak a rank "
          f"{summary['peak_gb']:.2f} GB; prefill logits vs route n's tp 1 "
          f"max |diff| {full_err:.3g} of the largest, greedy tokens agreeing "
          f"{agree:.3f} (no check: both bf16, at random weights); fp32 vs "
          f"tp 1 (2 × 96 + 2) at 2 layers {fp32_err:.3g} (tolerance "
          f"{X_FP32_TOL}), at 26 layers {deep_err:.3g} (tolerance "
          f"{X_FP32_FULL_TOL})")

    base = get_arch("qwen2-moe-a2.7b").model
    moe_cfg = mreplace(base, num_layers=X_MOE_LAYERS, dtype="float32",
                       moe=dataclasses.replace(
                           base.moe, num_experts=X_MOE_EXPERTS,
                           capacity_factor=X_MOE_CF))
    seq_cfg = small
    r4 = run_ranks(X_MOE_TP, "gloo", {"x": {"moe_cfg": moe_cfg,
                                            "seq_cfg": seq_cfg}},
                   fn=_x_mesh_job, timeout=900)
    mx = r4[0]["x"]
    check(all(r["x"]["dispatch"]["top"] < X_MOE_EXPERTS
              and r["x"]["dispatch"]["pad_prob"] == 0.0
              and r["x"]["dispatch"]["calls"] > 0 for r in r4),
          f"route x: a pad expert was selected or had a router prob: "
          f"{[r['x']['dispatch'] for r in r4]}")
    check(mx["moe_decode_vs_forward"] <= DECODE_TOL,
          f"route x: MoE decode at tp {X_MOE_TP} differs from the forward by "
          f"{mx['moe_decode_vs_forward']}")
    check(mx["seq_slots_a_rank"] == 32 // X_SEQ_SHARDS
          and mx["seq_vs_unsharded"] <= X_SEQ_TOL,
          f"route x: sequence-sharded decode: {mx}")
    launched = [r["x"]["launches"] for r in rk] + [r["x"]["launches"]
                                                  for r in r4]
    check(not any(ops.launches.values()) and not any(
        any(v.values()) for v in launched),
        f"route x: serving launched the port's kernels {launched}")
    print(f"route x: qwen2-moe-a2.7b at published widths, {X_MOE_LAYERS} "
          f"layers, {X_MOE_EXPERTS} experts at tp {X_MOE_TP} (padded to 60; "
          f"a rank's w_up {mx['moe_w_up_local']}): the top expert chosen "
          f"{max(r['x']['dispatch']['top'] for r in r4)} over "
          f"{mx['dispatch']['calls']} dispatches a rank, pad probs 0; decode "
          f"vs forward (fp32, capacity factor {X_MOE_CF}) "
          f"{mx['moe_decode_vs_forward']:.3g} (tolerance {DECODE_TOL}); "
          f"sequence-sharded decode over {X_SEQ_SHARDS} ranks "
          f"({mx['seq_slots_a_rank']} slots a rank) vs unsharded "
          f"{mx['seq_vs_unsharded']:.3g} (tolerance {X_SEQ_TOL})")
    return {"tp2": dict(summary, prefill_vs_tp1_rel_err=full_err,
                        greedy_agree=agree, fp32_vs_tp1_rel_err=fp32_err,
                        fp32_26_layers_vs_tp1_rel_err=deep_err,
                        fp32=_serve_summary(fp32, 2, 2, fp32["peak_gb"] * 1e9,
                                            cfg.vocab_size)),
            "moe_tp4": {k: mx[k] for k in ("moe_decode_vs_forward",
                                           "moe_w_up_local", "dispatch")},
            "seq": {k: mx[k] for k in ("seq_slots_a_rank",
                                       "seq_vs_unsharded")},
            "launches": dict(ops.launches)}


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
        mesh_held = phase_mesh_shapes(dev)
        large = phase_lm_shapes(dev, mesh_held)
    torch.cuda.empty_cache()
    print(f"phase 1 took {time.perf_counter() - t_phase:.1f} s")
    for name, (cases, worst, sigs) in mesh_held.items():
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], worst)
        kern[name]["cases_routes_m_o_q"] = cases
        print(f"kernel {name} vs twin at routes m, o and q's shapes: {cases} "
              f"cases, {len(sigs)} shapes, bitwise")
    for d, row in large.items():
        for name in ("topk_ef_sparse", "fedams_ingest"):
            t = row[name]
            kern[name].setdefault("largest_rows", {})[d] = t
            print(f"kernel {name} alone on route {row['route']}'s largest "
                  f"leaf, a (1, {d:,}) row: {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bytes']} bytes), "
                  f"{t['ms'] / t['bound_ms']:.2f}x the bound")
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
    t_phase = time.perf_counter()
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import init_params
    cmc = cm.ConvMixerConfig()
    mesh_res = route_m(lambda p, b: cm.convmixer_loss(p, b, cmc),
                       init_params(cm.convmixer_defs(cmc),
                                   torch.Generator().manual_seed(0)),
                       FederatedClassification(num_clients=M,
                                               image_shape=(32, 32, 3),
                                               alpha=0.3, seed=0),
                       mesh_held)
    m1 = route_m1(mesh_held)
    print(f"routes m and m1 took {time.perf_counter() - t_phase:.1f} s")
    #: the model routes in order (serving, then training, a family at a
    #: time), and the rounds each training route runs
    model_routes = {"n": route_n, "o": lambda: route_o(mesh_held),
                    "p": route_p, "q": lambda: route_q(mesh_held),
                    "r": route_r, "s": lambda: route_s(mesh_held),
                    "t": route_t, "u": lambda: route_u(mesh_held),
                    "v": route_v, "w": lambda: route_w(mesh_held),
                    "x": route_x}
    lm_rounds = {"o": LM_ROUNDS, "q": MOE_ROUNDS, "s": MLA_ROUNDS,
                 "u": RG_ROUNDS, "w": W_ROUNDS}
    zoo = {}
    for route, fn in model_routes.items():
        t_phase = time.perf_counter()
        zoo[route] = fn()
        zoo[route]["seconds"] = time.perf_counter() - t_phase
        print(f"route {route} took {zoo[route]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    rows = []
    for name, r in kern.items():
        runs = [(route, sl[route]["launches"][name]) for route in ROUTES]
        per_round = {route: n / ROUNDS for route, n in runs if n}
        mesh_n = sum(j["launches"][name] for j in mesh_res.values())
        runs += [("m", mesh_n), ("m1", m1["launches"][name])]
        runs += [(route, zoo[route]["launches"][name]) for route in lm_rounds]
        if mesh_n or m1["launches"][name]:
            per_round["m (all jobs, all ranks)"] = mesh_n
            per_round["m1"] = m1["launches"][name]
        for route, rounds in lm_rounds.items():
            if zoo[route]["launches"][name]:
                per_round[f"{route} (a round, all ranks)"] = (
                    zoo[route]["launches"][name] / rounds)
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
         "route_a_deterministic": det, "mesh": mesh_res, "mesh_m1": m1,
         "zoo": zoo},
        indent=1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
