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
   route w's xlstm-350m leaves at 4 layers as a rank at tp 2 holds them,
   1,024 to 25,755,648 values, the ingest on 2 clients); and ``topk_ef`` and
   ``fedams_update`` at every shape routes z and lm launch them
   (``phase_z_shapes``: xlstm-350m's leaves at 2 layers, 1,024 to the
   51,511,296-value embedding table, and the LM example's 100m preset's
   leaves, both FedAMS options).
   All bitwise (a NaN must meet a NaN).
   Each kernel is timed with CUDA events (median of 30 launches, L2
   flushed before each) beside its twin and its bound, and the two large
   ones also alone on each LM route's largest leaf (route o's
   589,824,000, q's 311,164,928, s's 117,440,512, u's 655,360,000 and
   w's 25,755,648 values; ``topk_ef`` and ``fedams_update`` on route z's
   51,511,296) beside their bytes bounds;
2. checks the round on the card against the same round on the CPU (the
   port's twins, which the CPU tests hold against the JAX package) on a
   small MLP problem, every route below (route g through the trainer, j
   through the async engine, l on randk positions drawn on the host), with
   the fault verdicts of routes h and i and j's flushes equal;
   then the block part: FedSim's local phase, one ``torch.func.vmap``
   program over a block of clients (``FedSim._train_block``), against its
   plain twin ``core.local.train_clients_loop`` (the clients one after
   another, autograd's gradient) on route a's round-0 block (n = 10, K = 3,
   batch 20) of ConvMixer-256-8 and make_problem's ConvMixer and MLP: under
   deterministic algorithms the per-client largest difference beside the
   largest |Δ| (fails past ``BLOCK_TOL``) and whether the two are bitwise
   equal; each form's CUDA-event ms (deterministic and default mode) and
   peak memory over the baseline, beside the batched block's activations
   reckoned on the ConvMixers;
3. runs the FedCAMS round on ConvMixer-256-8 (random weights from a seed,
   synthetic CIFAR-shaped data), 6 rounds on each route, as users run it:
   each round a call of ``FedSim.round``, one replay of its program (one
   CUDA graph, captured at the first call after one dropped warm-up run;
   route j's dispatches and flushes replay two programs), so a route's
   launches are its graphs' kernel nodes (read from the driver) times
   their replays and the wrappers count the warm-ups' (route i's clip share is
   read from its rounds run eagerly under ``disable_graphs``, where the
   payloads' norms can be read on the host):
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
   Then, under deterministic algorithms, routes a, b, c, h and l (4
   rounds), make_problem's ConvMixer and MLP (``benchmarks/common.py``'s
   two problems rebuilt from the port's modules, route a's configuration,
   20 rounds) and routes d, e, f, g and i on that MLP (3 rounds) each run
   as an eager loop of ``FedSim.round`` under ``disable_graphs``, as R
   calls of ``FedSim.round`` through its program (one program, one
   capture, a replay a call; state, metrics and host counters bitwise the
   eager loop's; the graph's launches the eager loop's; each route's line
   prints the replay ms by CUDA events beside the eager round's, and a
   call's host ms beside the eager round's), and as one
   ``FedSim.run_rounds`` call: one CUDA graph capture and R replays, the
   whole call under
   ``torch.cuda.set_sync_debug_mode("warn")`` with no synchronizing CUDA
   operation from the first replay to the last and one after it (the
   metrics' read); the final state and every metric equal to the loop's
   to the bit; the wrappers launching in the call only in the warm-up
   run, the capture recording one round's launches, and the graph's
   nodes, read from the driver, holding one kernel node for each of
   them, so naming ``topk_ef_sparse_kernel`` and ``fedams_ingest_kernel`` (a and the two
   problems) and ``sign_ef_kernel`` (c). Routes a and b also run
   ``run_rounds`` once in the default mode, which the eager rounds above
   are timed in. Prints the eager round ms (host clock and CUDA events),
   the graph's replay ms (CUDA events), the whole call against the whole
   eager loop, and the card.
   Route j's line: its configuration over 3 cohorts through the dispatch
   and flush programs against the same under ``disable_graphs``, bitwise;
   route k's: 3 rounds through the round's program (the store's rows its
   static input) against the eager rounds, bitwise, the store's rows too.
   On h and i every round has survivors + rejected + crashed +
   deadline_cut = n, the EF rows of the clients the server did not ingest
   equal their pre-round rows to the bit, and the state stays finite.
   Every kernel launch counter is reset before a route and read after it;
   a route whose kernels never launched fails. Each route's final params,
   EF buffer and server state are hashed (``state_sha256``); route a's
   run_rounds part, run under deterministic algorithms, is the one two
   builds can be held equal on to the bit (local training on the card is
   not bit-reproducible otherwise). Wire routes also check that
   ``pack_uint`` and ``unpack_uint`` launched once a round for all n
   clients, that every encoded message is ``codec.nbytes(d)`` long and
   that each round bills n of them uplink;
4. runs the mesh backend (``core.mesh``): route m on four gloo ranks
   sharing the card — ConvMixer-256-8 as one flat leaf, 3 rounds of
   blocktopk ``sparse_topk`` fused and two-pass, equal to the port's
   FedSim to the bit (on that FedSim alone the local phase is the loop
   twin: the mesh trains a client a rank, and the batched block's grouped
   convolution is not the per-client one's bits on the card); then the model's 52-leaf tree, 3 rounds each of
   sparse at n = 3 of 4, hierarchical (2 × 2), packed sign, dense
   blocktopk, dense sign, ZeRO-sharded server state, 6 of crashes with bit
   flips, and 3 rounds through ``FederatedTrainer(mesh=...).run``; the
   flat anchor's fused rounds once more as one call of
   ``core.mesh.build_fed_rounds_scan`` (on gloo its staged body, run
   eagerly, ``captured`` false), equal to the loop to the bit — and route
   m1, the sparse fused round on one NCCL rank, then its rounds through
   ``build_fed_rounds_scan`` (6 eager rounds, then one program call: one
   round captured into a CUDA graph on the rank's NCCL stream after a
   warm-up round, replayed 6 times with no synchronizing CUDA operation
   between the first replay and the last and one after them; the graph's
   52 + 52 kernel nodes read from the driver; under deterministic
   algorithms state and metrics bitwise the loop's, and once more in the
   default mode; eager rounds and replays timed by CUDA events; then, under
   deterministic algorithms, the 6 rounds through the per-round step,
   ``MeshRounds.round``: one program, one capture, a replay a round,
   bitwise the eager loop). Each job checks its
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
   token, tokens/s and peak memory. Every serving route (n, p, r, t, v)
   serves through ``launch/programs.py``'s programs: one prefill and one
   decode capture a shape (one shared pool), a replay a token, no other
   capture; the first run is held to its eager twin under
   ``repro_torch.disable_graphs()`` (``TWIN_GEN`` tokens), those tokens
   and the prefill's logits to the bit, and prints the decode's kernel nodes ×
   replays and its ms a token against the twin's, each peak beside
   ``serve_reckoning``; a route's runs follow one another with no
   ``repro_torch.clear_caches()`` between them (each takes the session
   of the run before it: peak allocated and reserved printed), which
   frees the programs before a route, before the twin and after it;
6. trains gemma2-2b on the mesh (route o: published widths, 2 layers,
   745,549,056 params in 20 leaves) through ``launch/train.py``'s
   ``train`` on two gloo ranks sharing the card: fedcams, blockwise top-k
   1/64 over the sparse collective, the fused ingest through
   ``KernelImpl``, K = 2, batch 2 × 512 a client, 3 rounds. Each rank
   launches ``topk_ef_sparse`` and ``fedams_ingest`` once a leaf a round,
   at shapes phase 1 held; ``wire_up_bytes`` equals
   ``mesh_wire_bytes_tiers``; losses finite. Prints the reckoned and the
   measured peak memory a rank and rank 0's round ms. Route o1: the same
   configuration at one client on one NCCL rank, ``train`` with
   ``scan_rounds=0`` under ``disable_graphs`` (the eager loop) against
   ``scan_rounds=3`` (the 3 rounds as one captured graph replayed 3 times,
   20 + 20 kernel nodes), bitwise under deterministic algorithms, timed in
   both modes, its peak against ``lm_memory_reckoning``'s (the graph's
   pool: the round's temporaries); and, deterministic, ``train`` without
   ``scan_rounds`` through its per-round step (one capture, a replay a
   round), bitwise the eager loop. Routes o, q, s, u and w run ``train``
   as a user does, without ``scan_rounds``: each round one call of the
   per-round program (on o's and w's gloo ranks its staged body, run
   eagerly; on q's, s's and u's NCCL rank one captured round replayed a
   round, its kernel nodes the capture's launches, its peak printed
   beside the reckoning);
7. serves qwen2-moe-a2.7b at its published widths and full depth (route
   p, 24 layers, 14,315,735,040 params, 57.3 GB of fp32 weights drawn on
   the card from a seeded CUDA generator, bf16 compute) through ``launch/serve.py``: batch 4 × prompt 512 + 32 tokens
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
   2 × 512, 3 rounds, each one replay of ``train``'s per-round program
   (one capture). 19 ``topk_ef_sparse`` + 19 ``fedams_ingest`` a round
   (the graph's kernel nodes; the wrappers' in the warm-up) at shapes
   phase 1 held; ``wire_up_bytes`` as billed; losses and the local steps'
   aux loss (the warm-up round's steps and the last replay's) finite, the
   aux loss > 0. Prints round ms, the replays' ms and the peak memory with
   the graph's pool beside the reckoned eager peak;
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
   ``topk_ef_sparse`` + 41 ``fedams_ingest`` a round; the local steps'
   aux loss and MTP cross entropy finite and > 0;
11. serves recurrentgemma-2b at its published widths and full depth (route
   t: 26 layers, (RG-LRU, RG-LRU, local attention) × 8 and two RG-LRU
   layers, 2,658,690,560 params, 10.63 GB fp32 drawn on the card, bf16
   compute) as route n:
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
   as route n: batch 4 × 512 + 32, then at 2 of the 24 layers 1 × 4,608 +
   16 (two mLSTM q-chunks of 2,304; the sLSTM steps 4,608 times a layer);
   decode against the forward at 4 layers, fp32; the smoke config on the
   card against the CPU;
14. trains xlstm-350m at 4 of its 24 layers on the mesh at dp 2 × tp 2
   (route w:
   four gloo ranks sharing the card, each holding its model shards) through
   ``launch/train.py``'s ``train``: fedcams, blockwise top-k 1/64 over the
   sparse collective, the fused ingest, K = 2, batch 2 × 512 a client, 1
   round, 19 ``topk_ef_sparse`` + 19 ``fedams_ingest`` a rank a round on
   its model-local leaves at shapes phase 1 held, every replicated leaf of
   the final state the same on all four ranks to the bit; then dense
   FedAvg rounds in fp32 at one and two local steps, 2 of the 24 layers
   and 128 tokens, at dp 2 × tp 2 and at dp 2 × tp 1 from the same seeded
   init, the loss and the gathered params held together;
15. runs the model axis on the card (route x): gemma2-2b at full width and
   depth served at tp 2 on two gloo ranks (route n's weights; the prefill
   logits against route n's, the share of greedy tokens that agree), and
   in fp32 against tp 1 at 2 layers within 1e-4, at 26 within 1e-3;
   qwen2-moe-a2.7b at
   published widths, 2 layers and 58 experts at tp 4 (padded to 60): no
   pad expert chosen, decode = forward; a decode over a cache split across
   2 ranks of the sequence axis (the context of ``launch/steps.py``'s
   ``serve_ctx``) against the unsharded one within 1e-5;
16. runs ``launch/steps.py``'s decode entry at long_500k (route y):
   gemma2-2b at full width and depth, bf16 weights drawn on the card,
   built with ``steps.build_decode_step`` on a (2, 1) ("data", "model")
   mesh of two gloo ranks sharing the card, each holding 262,144 of the
   524,288 cache slots (the cache drawn as one global cache and cut):
   8 tokens from position 524,280, ms a token and peak memory a rank
   within 3 % of the peak ``launch/op_analysis`` reckons on meta; the same
   steps
   unsharded in this process (the largest logit difference, unbounded at
   bf16) and at 2 layers in fp32 within 1e-5. ``launch/op_analysis``'s
   count of that step and of route n's decode shape (batch 4, 544 slots,
   built on a one-rank mesh) on the card equals its count on meta (ops,
   FLOPs, bytes, collective bytes by kind); the step roofline of both
   and of route o's train round (built with ``steps.build_train_step``
   and ``KernelImpl``: 3 rounds) against ``h100_sxm`` beside the measured
   step; and the dry run of gemma2-2b at long_500k on the 16 × 16 mesh
   (``python -m repro_torch.launch.dryrun``) prints ``[ok]``;
17. runs xlstm-350m's train_4k round on the card (route z) through the
   step builders' program: the step ``steps.build_train_step`` builds (a
   ``launch.programs.TrainStep``) with the dry run's settings (fedcams,
   top-k 1/64 over the dense uplink, remat "full"; K = 1 where its CLI
   says 4) at published widths, 2 layers (one mLSTM, one sLSTM), on one
   NCCL rank. At batch 16 × 512 its round, captured, equals its eager
   twin under ``disable_graphs()`` to the bit under deterministic
   algorithms. At one client's share of train_4k (batch 16 × 4,096): the
   peak op_analysis reckons on meta first (at most 70 GB), then 2 calls
   of ``b.fn``: one captured graph (the first call a warm-up round, the
   capture and a replay, the second a replay), its nodes by type and by
   port kernel read from the driver, 19 ``topk_ef`` + 19
   ``fedams_update`` nodes (meta's count, the capture's launches) at
   shapes phase 1 held, the first call's parts (the warm-up by CUDA
   events, the capture's and the instantiation's host seconds), each
   replay's ms, losses and state finite, the peak within 3 % of the
   reckoning.
   One sLSTM layer (batch 16, fp32) against a witness that indexes
   ``pre[:, i]`` a step, the loop the port had before it stepped over
   ``pre.unbind(1)``: at S = 512 the output and every gradient equal
   (``==``; ``scripts/slstm_time.py`` times both at S = 4,096). The
   card's count of the 2-layer loss and gradient at 16 × 512 equals
   meta's, and run plainly its peak is within 3 % of meta's reckoning;
18. runs ``examples/train_lm_fedcams_torch.py``'s ``rank_main`` on the
   NCCL rank (route lm: ``--preset 100m --clients 1 --tp 1 --rounds 3``):
   through its per-round program (one captured round, a replay a round)
   and under ``disable_graphs()``, under deterministic algorithms: the
   losses and the final state to the bit, the graph's port-kernel nodes
   (read from the driver) the capture's launches, the replays' ms beside
   the eager rounds'.
The routes' ranks start three times: four gloo ranks run routes m, w and
x's four-rank jobs in turn, two gloo ranks those of o, w's tp 1 pairs, x's
tp 2 serving and y, one NCCL rank those of m1, o1, q, s, u, z and lm; each group
starts at its first route (a start and teardown cost 12-20 s). Every
phase and route prints its seconds (a route that starts a group pays its
start and all its jobs), each job its own, and a line before the kernels
line all of them.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(``launches``: the wrappers' counts over phase 3 and the later routes —
the programs' warm-ups and the eager twins; ``graph_launches``, apart:
phase 3's round programs', the run_rounds graphs' and the mesh programs'
(m1, o1, q, s, u, z, lm) kernel nodes times their replays) and, last, ``{"ok": true, "device": {...}}``. Exits nonzero, with no result,
without CUDA or when any check fails. Longer output goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
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


#: route w: xlstm-350m at its published widths, ``W_LAYERS`` of its 24
#: layers (223,439,872 params in 19 leaves) on dp ``W_DP`` × tp ``W_TP``:
#: four gloo ranks sharing the card. Its step sizes are the train CLI's ``--eta-l
#: 0.001 --eta 0.01``: at the defaults (η_l = 0.05) the first local step
#: drives an mLSTM input gate below -88, where the normalizer's exp(-m)
#: overflows and the reference's and the port's backward give NaN (ROADMAP
#: Queue 3 item 27); at η_l = 0.001 its rounds stay finite on the card.
#: 4 layers and 1 round, for the script's time: all 24 took ~31 s a
#: round, 12 took ~12 s; the second of 2 rounds took 4.9 s and repeated the
#: first's launches, shapes and checks
W_DP, W_TP, W_ROUNDS, W_ETA, W_ETA_L = 2, 2, 1, 0.01, 0.001
W_LAYERS = 4


def w_fed():
    """Route w's ``FedConfig``: route o's at ``W_DP`` clients, η ``W_ETA``
    and η_l ``W_ETA_L``."""
    return dataclasses.replace(lm_fed(W_DP), eta=W_ETA, eta_l=W_ETA_L)


def xlstm_cfg():
    """Route v's model: xlstm-350m at its published widths and depth (bf16
    compute, the config's)."""
    from repro_torch.configs.registry import get_arch
    return get_arch("xlstm-350m").model


def w_cfg():
    """Route w's model: xlstm-350m at ``W_LAYERS`` layers."""
    return lm_cfg("xlstm-350m", W_LAYERS)


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
    """The leaf sizes routes o, o1, q, s, u and w select and ingest (one
    (1, d_leaf) row a leaf; route w's are each rank's model-local leaves
    at tp = ``W_TP``) → the client counts their fused ingests gather at
    that size (route o's ``LM_CLIENTS``, route w's ``W_DP``, the others'
    one)."""
    out = {}
    for cfg, n, tp in ((lm_cfg(), LM_CLIENTS, 1), (lm_cfg(), 1, 1),
                       (moe_cfg(), 1, 1),
                       (mla_train_cfg(), 1, 1), (rg_train_cfg(), 1, 1),
                       (w_cfg(), W_DP, W_TP)):
        for d in leaf_sizes(cfg, tp):
            out.setdefault(d, set()).add(n)
    return {d: sorted(out[d]) for d in sorted(out)}


def phase_lm_shapes(dev, out: dict) -> dict:
    """``topk_ef_sparse`` and ``fedams_ingest`` at every shape routes o,
    q, s, u and w launch them (:func:`lm_kernel_shapes`), bitwise against
    the twins, into ``out`` (:func:`phase_mesh_shapes`'s record): for each
    leaf size d (512 to recurrentgemma-2b's 655,360,000-value tied
    embedding; route w's xlstm-350m leaves as a rank at tp = 2 holds them,
    1,024 to 25,755,648 values) a
    (1, d) row on random inputs, and on ``ref.topk_hard_cases`` up to
    ``LM_HARD_MAX`` values; the fused ingest of the routes' client counts'
    selections (made by the selection kernel on random totals), option 1,
    and option 2 up to ``LM_HARD_MAX``. The largest row's twins hold
    several 2.4 GB tensors; each leaf's are freed before the next.

    The largest leaf of each route (route o's 589,824,000-value table,
    route q's 311,164,928-value untied one, route s's 117,440,512-value
    expert stacks, route u's 655,360,000-value table, route w's
    25,755,648-value embedding shard) is also timed
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
               max(leaf_sizes(w_cfg(), W_TP)): ("w", W_DP)}
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


#: route z: xlstm-350m's train_4k round as the dry run builds it
#: (``launch/dryrun.py``'s CLI at its defaults: fedcams, top-k 1/64 over the
#: dense uplink, so ``topk_ef`` and the two-pass ``fedams_update``; remat
#: "full"), one client's share of train_4k's 256 sequences over 16 clients
#: (batch 16 x 4,096) on one NCCL rank at tp 1. Reduced: depth 24 -> 2, one
#: mLSTM and one sLSTM layer (at 24 layers the dry run counts 40.2 M ops a
#: round, a launch each), the local steps 4 -> 1 (``--local-steps``: at
#: K = 4 the 2 rounds took 124-139 s of the script's 1,200, host-bound on
#: 3.35 M launches a round; at K = 2 one round took 44.5 s and repeated
#: its first local step's peak). Its rounds run through the step's
#: program: 2 calls, the first a warm-up round, the capture and a replay,
#: the second a replay alone
Z_LAYERS, Z_SEQ, Z_BATCH, Z_ROUNDS, Z_LOCAL_STEPS = 2, 4096, 16, 2, 1
#: the most route z's step may reckon (op_analysis on meta: arguments +
#: temporaries) on the card; over it the batch would have to be cut
Z_MAX_GB = 70.0
#: how far a step's peak on the card (``max_memory_allocated``) may be from
#: op_analysis's reckoning on meta (arguments + temporaries), as a share of
#: the reckoning: routes y and z and route z's loss + gradient at
#: Z_CHECK_SEQ (ROADMAP Queue 3 item 35)
RECKON_TOL = 0.03
#: route z's round through the program against its eager twin, bitwise
#: under deterministic algorithms; the sLSTM layer against its indexing
#: witness, bitwise (batch Z_BATCH, fp32; scripts/slstm_time.py times both
#: at Z_SEQ); the card's count of the 2-layer loss and gradient against
#: meta's: each at batch Z_BATCH x Z_CHECK_SEQ
Z_CHECK_SEQ = 512


def z_cfg():
    """Route z's model: xlstm-350m at ``Z_LAYERS`` layers."""
    return lm_cfg("xlstm-350m", Z_LAYERS)


def z_configs():
    """Route z's ``FedConfig`` and ``TrainConfig``: the dry run's, at
    ``Z_LOCAL_STEPS`` local steps."""
    from repro_torch.launch import dryrun
    return dryrun.build_configs(dryrun.parser().parse_args(
        ["--local-steps", str(Z_LOCAL_STEPS)]))


def phase_z_shapes(dev, out: dict) -> dict:
    """``topk_ef`` and ``fedams_update`` at every shape routes z and lm
    launch them, bitwise against the twins, into ``out``
    (:func:`phase_mesh_shapes`' record): for each leaf size d of
    :func:`z_cfg` (1,024 to the 51,511,296-value embedding table) and of
    the LM example's model at :data:`LM_EX_FLAGS` a (1, d) row at the leaf's block
    layout and k on random inputs, and on ``ref.topk_hard_cases`` up to
    ``LM_HARD_MAX`` values; ``fedams_update`` at N = d for both options.
    The largest leaf is also timed alone: each kernel's CUDA-event ms
    (median of 30, L2 flushed, the EF row restored before each selection)
    beside its bytes bound. Returns those times by leaf size."""
    from repro_torch.core.compressors import block_layout
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(5)
    hold = lambda *a, **k: _hold(out, "routes z and lm", *a, **k)
    rows = torch.zeros(1, dtype=torch.int64, device=dev)
    ratio = z_configs()[0].compress_ratio
    ex = lm_example()
    args = ex.parser().parse_args(list(LM_EX_FLAGS))
    check(args.ratio == ratio, f"route lm's ratio {args.ratio} is not route "
          f"z's {ratio}: hold its shapes at its own k")
    leaves = sorted(set(leaf_sizes(z_cfg()))
                    | set(leaf_sizes(ex.model_config(args.preset))))
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)
    kw = dict(eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4)
    seg = 2048
    timed = {}
    for d in leaves:
        bs, _ = block_layout(d, BLOCK)
        k = max(1, int(round(ratio * bs)))
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
            hold("topk_ef", f"d={d}, block={bs}, k={k}, {what}",
                 ops.topk_ef_cuda, ref.topk_ef, (x, e, rows),
                 dict(k=k, block=bs), 1)
        ins = (torch.randn(d, generator=g, device=dev),
               torch.randn(d, generator=g, device=dev) * 1e-3,
               torch.rand(d, generator=g, device=dev) * 1e-4,
               torch.rand(d, generator=g, device=dev) * 2e-4,
               torch.randn(d, generator=g, device=dev) * 1e-2)
        for option in (1, 2):
            hold("fedams_update", f"N={d}, option {option}",
                 ops.fedams_update_cuda, ref.fedams_update_ref, ins,
                 dict(kw, option=option))
        if d == leaves[-1]:
            xt, et0 = inputs[0][1:]
            et = et0.clone()

            def restore():
                et.copy_(et0)
                flush.sum()    # read 256 MB: L2 holds nothing used

            # x read, the EF row read and written, the hat written
            nb_topk, nb_upd = 4 * 4 * d + 8, 9 * 4 * d
            timed[d] = {"route": "z", "topk_ef": dict(
                ms=time_ms(lambda: ops.topk_ef_cuda(
                    xt, et, rows, k=k, block=bs, check_rows=False), restore),
                bytes=nb_topk, bound_ms=nb_topk / PEAK_BYTES_S * 1e3),
                "fedams_update": dict(
                ms=time_ms(lambda: ops.fedams_update_cuda(
                    *ins, option=1, **kw), flush.sum),
                bytes=nb_upd, bound_ms=nb_upd / PEAK_BYTES_S * 1e3)}
            del xt, et, et0
        del inputs, x, e, ins
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
    # the recording reads the norms on the host: the eager round
    with recording_norms(norms), disable_graphs():
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
    # the trainer's rounds replay the round's program
    graph = round_launches("route g", tr._sim, rounds, counts)
    check(graph["pack_uint"] == graph["unpack_uint"] == 2 * rounds,
          f"route g: pack_uint/unpack_uint launched {graph['pack_uint']}/"
          f"{graph['unpack_uint']} times in {rounds} rounds (2 a round)")
    check(graph["fedams_update"] == rounds,
          f"route g: fedams_update launched {graph['fedams_update']} times")
    nbytes = tr._sim.codec.nbytes(d)
    # encoded in the warm-up and the capture; the replays rerun them
    check(len(sizes) == 2 * (N_CLI + 1) and set(sizes) == {nbytes},
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
                gamma=[h["gamma"] for h in hist], launches=counts,
                graph_launches=graph, wire=wire,
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


def disable_graphs():
    """``repro_torch.disable_graphs()``: inside it the per-round entry
    points run their eager bodies, the twins the programs are held to."""
    from repro_torch import disable_graphs as eager
    return eager()


def round_launches(label, sim, rounds: int, wrapper: dict) -> dict:
    """The launches of ``rounds`` rounds (cohorts and flushes on route j)
    through ``sim``'s programs: each graph's kernel nodes
    (:func:`graph_census`, held to its capture's record) times its replays, summed; the wrappers
    (``wrapper``, counted over the same rounds) launched only in the
    warm-ups, one run of each program. Returns the graphs' launches."""
    from repro_torch.core.sim import WARMUP_ROUNDS
    graph = {k: 0 for k in KERNEL_SYMBOLS}
    warm = {k: 0 for k in KERNEL_SYMBOLS}
    for key, prog in sim._programs.items():
        check(prog.graph is not None, f"{label}: its {key[0]} program has no "
              f"graph")
        nodes = graph_census(prog.graph)[1]
        check(nodes == {k: prog.counts.get(k, 0) for k in nodes},
              f"{label}: the {key[0]} graph's kernel nodes {nodes} against "
              f"its capture's launches {dict(prog.counts)}")
        for k, n in nodes.items():
            graph[k] += n * prog.replays
            warm[k] += n * WARMUP_ROUNDS
    check(warm == {k: wrapper.get(k, 0) for k in warm},
          f"{label}: the wrappers launched {wrapper} in {rounds} rounds, the "
          f"programs' warm-ups {warm}")
    return graph


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
    # the dispatches and flushes replay their two programs
    graph = round_launches("route j", sim, rounds, counts)
    check(len(sim._programs) == 2 and
          graph["topk_ef_sparse"] == rounds and
          graph["fedams_ingest"] == flushes and
          graph["fedams_update"] == 0,
          f"route j: launches {graph} for {rounds} cohorts and {flushes} "
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
    pair = async_pair(loss, p0, {k: v[:3] for k, v in batches.items()},
                      ids[:3], p)
    return dict(cohorts=rounds, flushes=len(mets), run_ms=ms, loss=losses,
                straggler_prob=p, per_flush=per_flush, launches=counts,
                graph_launches=graph, anchor_bitwise=True, programs=pair,
                state_sha256=state_digest(st))


def _timed_calls(fn, events: list):
    """``fn`` with each call timed by a pair of CUDA events (appended to
    ``events``)."""
    def timed(*args, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return out
    return timed


def async_pair(loss, p0, batches, ids, p) -> dict:
    """Route j's line: its configuration (B = 5 of 10, ``inv_sqrt``) over
    ``len(ids)`` cohorts under deterministic algorithms, the async engine's
    ``run_rounds`` through its dispatch and flush programs against its
    run under ``disable_graphs`` (each eager step timed by CUDA events):
    the state and every flush's metrics to the bit; two programs, two
    captures, a replay a step (each timed by events); the whole calls on
    the host's clock. Returns the numbers."""
    from repro_torch.core.sim import FedSim
    from repro_torch.kernels import ops
    card = card_line()
    med = lambda xs: float(np.median(xs))
    cohorts = len(ids)
    make = lambda: FedSim(loss, _route_cfg("j", M, N_CLI, K_STEPS),
                          network=wire_network(M, p))
    with deterministic():
        sim_e = make()
        st_e = sim_e.init(p0)
        steps = {"dispatch": [], "flush": []}
        sim_e._async_dispatch = _timed_calls(sim_e._async_dispatch,
                                             steps["dispatch"])
        sim_e._async_flush = _timed_calls(sim_e._async_flush, steps["flush"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with disable_graphs():
            st_e, mets_e = sim_e.run_rounds(st_e, batches, ids)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        sim_p = make()
        st_p = sim_p.init(p0)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with graph_spy() as spy:
            st_p, mets_p = sim_p.run_rounds(st_p, batches, ids)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        graph = round_launches("route j programs", sim_p, cohorts,
                               dict(ops.launches))
    kind = {id(prog.graph): key[0] for key, prog in sim_p._programs.items()}
    replay = {"dispatch": [], "flush": []}
    for g, (e0, e1) in zip(spy["graphs"], spy["events"]):
        replay[kind[g]].append(e0.elapsed_time(e1))
    eager = {k: [e0.elapsed_time(e1) for e0, e1 in v]
             for k, v in steps.items()}
    diff = same_state(st_e, st_p)
    bad = [(r, key) for r, (a, b) in enumerate(zip(mets_e, mets_p))
           for key in a if key not in b or not _same_metric(a[key], b[key])]
    check(not diff and not bad and len(mets_p) == len(mets_e),
          f"route j programs: differ from the eager steps in {diff}, "
          f"metrics {bad[:6]}")
    check(len(sim_p._programs) == 2 and spy["captures"] == 2
          and len(replay["dispatch"]) == cohorts
          and len(replay["flush"]) == len(mets_p),
          f"route j programs: {len(sim_p._programs)} programs, "
          f"{spy['captures']} captures, replays "
          f"{ {k: len(v) for k, v in replay.items()} }")
    out = dict(programs=len(sim_p._programs), captures=spy["captures"],
               replay_ms=replay, eager_step_ms=eager, call_ms=call_ms,
               eager_call_ms=eager_ms, graph_launches=graph, bitwise=True)
    print(f"route j programs, deterministic algorithms, {cohorts} cohorts, "
          f"{len(mets_p)} flushes: programs built {out['programs']}, "
          f"captures {out['captures']}; replay ms (CUDA events) median "
          f"dispatch {med(replay['dispatch']):.3f} / flush "
          f"{med(replay['flush']):.3f} beside the eager steps' "
          f"{med(eager['dispatch']):.3f} / {med(eager['flush']):.3f}; the "
          f"whole run_rounds call {call_ms:.1f} ms (with both warm-ups and "
          f"captures) beside the eager call's {eager_ms:.1f} ms; state, "
          f"every flush's metrics and host counters bitwise the eager "
          f"steps'; {card}")
    return out


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
    graph = round_launches("route k", sim, rounds, counts)
    check(graph["topk_ef_sparse"] == 2 * rounds and
          graph["fedams_update"] == rounds and graph["fedams_ingest"] == 0,
          f"route k: launches {graph} in {rounds} rounds")
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
    # the rounds through the round's program against its eager twin: the
    # store's (n, d) block is the program's static input
    with deterministic():
        pair = round_pair("k", lambda: (lambda s: (s, s.init(p0)))(FedSim(
            loss, _route_cfg("k", M_K, N_CLI, K_STEPS))), plan[:3],
            prefetch=True)
        (s_e, s_p), touched = pair["sims"], np.unique(stacked(plan[:3])[0])
        check(np.array_equal(s_e._efs.gather(touched).view(np.int32),
                             s_p._efs.gather(touched).view(np.int32)),
              "route k: the store's rows differ between the round's "
              "program and the eager rounds")
    prog = round_pair_line("k (the EF store)", pair, card_line())
    return dict(round_ms=ms[1:], round0_ms=ms[0], loss=losses,
                launches=counts, graph_launches=graph, ef_block=list(block),
                programs=prog,
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
    graph = round_launches("route l", sim, rounds, counts)
    check(graph["fedams_update"] == rounds and sum(graph.values()) ==
          rounds, f"route l: launches {graph} in {rounds} rounds")
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
                launches=counts, graph_launches=graph, k=k,
                state_sha256=state_digest(st))


#: the routes whose rounds phase 3 also runs through ``FedSim.run_rounds``
#: (one captured CUDA graph, replayed), each held to an eager loop
GRAPH_ROUTES = ("a", "b", "c", "h", "l")
#: their rounds there: each runs them three times (eager, the round's
#: program, run_rounds), a and b four; fewer than phase 3's own, for the
#: script's time
GRAPH_ROUNDS = 4
#: the routes whose graph is also run in the default mode, where phase 3's
#: eager rounds are timed
DEFAULT_MODE_ROUTES = ("a", "b")
#: make_problem's ConvMixer and MLP (``benchmarks/common.py``, rebuilt from
#: the port's own modules: the card has no jax), and their rounds
PROBLEMS = ("convmixer", "mlp")
PROBLEM_ROUNDS = 20
#: the other round paths' captures (codecs, two-way, dense EF, sign with
#: faults), on make_problem's MLP
MLP_ROUTES = ("d", "e", "f", "g", "i")
MLP_ROUNDS = 3
#: the hand-written kernels whose symbols a route's captured graph names
GRAPH_SYMBOLS = {"a": ("topk_ef_sparse", "fedams_ingest"),
                 "c": ("sign_ef",)}
#: each kernel's device functions: its wrapper's C entry launches one of
#: them, once a call
KERNEL_SYMBOLS = {"topk_ef_sparse": ("topk_ef_sparse_kernel",),
                  "topk_ef": ("topk_ef_kernel",),
                  "sign_ef": ("sign_ef_kernel",),
                  "fedams_ingest": ("fedams_ingest_kernel",),
                  "fedams_update": ("fedams_update_kernel",),
                  "pack_uint": ("pack_bits_kernel", "pack_groups_kernel"),
                  "unpack_uint": ("unpack_bits_kernel",
                                  "unpack_groups_kernel")}
#: the warning of ``torch.cuda.set_sync_debug_mode("warn")``
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def graph_spy():
    """Counts the CUDA graph captures and replays made inside and times
    each replay by a pair of CUDA events on the stream it replays on. The
    whole runs under ``torch.cuda.set_sync_debug_mode("warn")`` with each
    warning of a synchronizing CUDA operation recorded: ``syncs_before``
    holds, at each replay, how many came before it; ``syncs``, on exit,
    how many came in all; ``graphs``, the ``id`` of the graph each replay
    replayed (not the graph: a kept graph would keep its memory pool)."""
    G = torch.cuda.CUDAGraph
    begin, replay = G.capture_begin, G.replay
    rec = {"captures": 0, "events": [], "syncs_before": [], "syncs": 0,
           "graphs": []}
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def syncs():
            return sum(SYNC_WARNING in str(w.message) for w in caught)

        def spy_begin(self, *args, **kw):
            rec["captures"] += 1
            return begin(self, *args, **kw)

        def spy_replay(self):
            rec["syncs_before"].append(syncs())
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            replay(self)
            e1.record()
            rec["events"].append((e0, e1))
            rec["graphs"].append(id(self))

        G.capture_begin, G.replay = spy_begin, spy_replay
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield rec
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            G.capture_begin, G.replay = begin, replay
            rec["syncs"] = syncs()


#: the seconds :func:`graph_census` took in this process, in all
DUMP_S = [0.0]

#: CUgraphNodeType values (the driver's ``cuda.h``) by name
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


class KernelNodeParams(ctypes.Structure):
    """The driver's ``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_census(graph) -> tuple:
    """A captured graph's nodes read from the driver, on
    ``CUDAGraph.raw_cuda_graph()`` (every program keeps its graph with
    ``keep_graph=True``): (its nodes by type, its kernel nodes by port
    kernel). Each kernel node's function (``cuGraphKernelNodeGetParams``)
    is named by ``cuFuncGetName`` (``cuKernelGetName`` where the node holds
    a library kernel) and matched to :data:`KERNEL_SYMBOLS`. No DOT file,
    whatever the graph's size."""
    t0 = time.perf_counter()
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        rc = fn(*args)
        check(rc == 0, f"{fn.__name__} returned CUresult {rc}")

    g = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    call(cu.cuGraphGetNodes, g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes, g, nodes, ctypes.byref(n))
    owner = {sym: name for name, syms in KERNEL_SYMBOLS.items()
             for sym in syms}
    # the longest symbol first: none is a prefix match of another's name
    sym = re.compile("(?<![A-Za-z_])(" + "|".join(
        sorted(map(re.escape, owner), key=len, reverse=True)) + ")")
    named = {}

    def port_kernel(getter, handle):
        if (getter, handle) not in named:
            name = ctypes.c_char_p()
            call(getattr(cu, getter), ctypes.byref(name),
                 ctypes.c_void_p(handle))
            m = sym.search(name.value.decode())
            named[getter, handle] = owner[m.group(1)] if m else None
        return named[getter, handle]

    kind, prm = ctypes.c_int(0), KernelNodeParams()
    types, kernels = {}, dict.fromkeys(KERNEL_SYMBOLS, 0)
    for node in nodes:
        node = ctypes.c_void_p(node)
        call(cu.cuGraphNodeGetType, node, ctypes.byref(kind))
        t = NODE_TYPES.get(kind.value, str(kind.value))
        types[t] = types.get(t, 0) + 1
        if t != "kernel":
            continue
        call(cu.cuGraphKernelNodeGetParams_v2, node, ctypes.byref(prm))
        k = (port_kernel("cuFuncGetName", prm.func) if prm.func
             else port_kernel("cuKernelGetName", prm.kern))
        if k is not None:
            kernels[k] += 1
    DUMP_S[0] += time.perf_counter() - t0
    return types, kernels


def graph_nodes(sim) -> dict:
    """The kernel nodes of the one graph ``sim.run_rounds`` captured
    (:func:`graph_census`), and the capture's wrapper launches
    (``_Program.counts``)."""
    progs = list(sim._programs.values())
    check(len(progs) == 1 and progs[0].graph is not None,
          f"{len(progs)} run_rounds programs")
    return graph_census(progs[0].graph)[1], dict(progs[0].counts)


def _same_metric(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().reshape(()).view(torch.int32)
        return isinstance(b, torch.Tensor) and torch.equal(
            a, b.detach().cpu().reshape(()).view(torch.int32))
    return a == b


def round_pair(label, make, plan, seeded: bool = False,
               prefetch: bool = False) -> dict:
    """One configuration twice from the same init, under deterministic
    algorithms (the caller's): ``len(plan)`` eager ``FedSim.round`` calls
    under ``disable_graphs`` (each timed to a synchronize on the host's
    clock, and by CUDA events), then as many calls through the round's
    program, as users run it (each timed on the host to a synchronize; its
    replays by CUDA events under :func:`graph_spy`). The final state, every
    metric and the host counters equal the eager loop's to the bit; one
    program, one capture and a replay a call; the graph's launches (kernel
    nodes × replays) equal the eager loop's wrapper launches, and the
    wrappers launched in the calls only in the warm-up. ``seeded``: each
    round a generator seeded with its index; ``prefetch``: each round
    names the next round's ids (the EF store's prefetch). Returns the two
    sims, states, metrics and the numbers."""
    from repro_torch.kernels import ops
    rounds = len(plan)
    gen = lambda r: torch.Generator().manual_seed(r) if seeded else None
    nxt = lambda r: (plan[r + 1][0] if prefetch and r + 1 < rounds
                     else None)
    sim, st = make()
    torch.cuda.synchronize()
    ops.reset_launches()
    ms, ev, mets = [], [], []
    with disable_graphs():
        for r, (idx, b) in enumerate(plan):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            st, met = sim.round(st, b, idx, gen(r), prefetch_idx=nxt(r))
            e1.record()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ev.append(e0.elapsed_time(e1))
            mets.append(met)
    eager = dict(ops.launches)
    check(not sim._programs, f"round {label}: the eager loop made a program")
    sim_p, st_p = make()
    torch.cuda.synchronize()
    ops.reset_launches()
    pms, mets_p = [], []
    with graph_spy() as spy:
        for r, (idx, b) in enumerate(plan):
            t0 = time.perf_counter()
            st_p, met = sim_p.round(st_p, b, idx, gen(r),
                                    prefetch_idx=nxt(r))
            torch.cuda.synchronize()
            pms.append((time.perf_counter() - t0) * 1e3)
            mets_p.append(met)
    wrapper = dict(ops.launches)
    graph = round_launches(f"round {label}", sim_p, rounds, wrapper)
    replay = [e0.elapsed_time(e1) for e0, e1 in spy["events"]]
    diff = same_state(st, st_p)
    bad = [(r, key) for r, (a, b) in enumerate(zip(mets, mets_p))
           for key in a if key not in b or not _same_metric(a[key], b[key])]
    check(not diff and not bad, f"round {label}: the program differs from "
          f"the eager loop in {diff}, metrics {bad[:6]}")
    check(len(sim_p._programs) == 1 and spy["captures"] == 1
          and len(replay) == rounds,
          f"round {label}: {len(sim_p._programs)} programs, "
          f"{spy['captures']} captures, {len(replay)} replays for {rounds} "
          f"calls")
    check(graph == {k: eager.get(k, 0) for k in graph},
          f"round {label}: the graph's launches {graph} against the eager "
          f"loop's {eager}")
    return dict(sims=(sim, sim_p), states=(st, st_p), mets=(mets, mets_p),
                eager_ms=ms, eager_event_ms=ev, eager=eager,
                program_ms=pms, replay_ms=replay, wrapper=wrapper,
                graph=graph, programs=len(sim_p._programs),
                captures=spy["captures"])


def round_pair_line(label, r: dict, card: str) -> dict:
    """Print a :func:`round_pair`'s line; its numbers, for the record."""
    med = lambda xs: float(np.median(xs))
    rest = lambda xs: xs[1:] if len(xs) > 1 else xs
    n = len(r["replay_ms"])
    print(f"round {label}, deterministic algorithms, {n} calls: programs "
          f"built {r['programs']}, captures {r['captures']}; the replay ms "
          f"(CUDA events) median {med(r['replay_ms']):.3f} "
          f"{[round(t, 3) for t in r['replay_ms']]} beside the eager "
          f"round's {med(rest(r['eager_event_ms'])):.3f} by events (round 0"
          f" excluded), {med(rest(r['eager_event_ms'])) / med(r['replay_ms']):.2f}x;"
          f" round's whole call on the host's clock median "
          f"{med(rest(r['program_ms'])):.3f} ms (call 0, with the warm-up "
          f"and the capture, {r['program_ms'][0]:.1f}) beside the eager "
          f"round's {med(rest(r['eager_ms'])):.3f} (round 0 "
          f"{r['eager_ms'][0]:.1f}); state, metrics and host counters "
          f"bitwise the eager loop's; graph launches "
          f"{ {k: v for k, v in r['graph'].items() if v} }; {card}")
    return {k: v for k, v in r.items() if k not in ("sims", "states",
                                                    "mets")}


def graph_run(label, sim, st, batches, ids, rngs, rounds: int) -> dict:
    """One ``FedSim.run_rounds`` call under :func:`graph_spy`, checked: one
    capture, ``rounds`` replays, no synchronizing CUDA operation from the
    first replay to the last and one after it (the metrics' one read), and
    the graph's kernel nodes one for each launch its capture recorded.
    Returns its state and metrics, the replays' ms (CUDA events), the
    call's ms (host clock, to a synchronize after it), the wrappers'
    launches in the call (the warm-up's), and the graph's launches: its
    kernel nodes times the replays counted."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with graph_spy() as spy:
        st, mets = sim.run_rounds(st, batches, ids, rngs)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    wrapper = dict(ops.launches)
    replay_ms = [e0.elapsed_time(e1) for e0, e1 in spy["events"]]
    check(spy["captures"] == 1 and len(replay_ms) == rounds,
          f"run_rounds {label}: {spy['captures']} captures, "
          f"{len(replay_ms)} replays for {rounds} rounds")
    at = spy["syncs_before"]
    check(at[-1] == at[0] and spy["syncs"] - at[-1] == 1,
          f"run_rounds {label}: synchronizing CUDA operations counted "
          f"{at} at the replays and {spy['syncs']} in all; none between "
          f"the replays and one after them expected")
    nodes, captured = graph_nodes(sim)
    check(nodes == captured, f"run_rounds {label}: the graph's kernel "
          f"nodes {nodes} against the capture's launches {captured}")
    return dict(state=st, mets=mets, replay_ms=replay_ms, call_ms=call_ms,
                syncs_before_replays=at[0], syncs=spy["syncs"],
                wrapper=wrapper, captured=captured,
                graph={k: n * len(replay_ms) for k, n in nodes.items()})


def run_rounds_route(name, make, plan, expect, symbols=(),
                     seeded: bool = False, default_mode: bool = False) -> dict:
    """One configuration three times under deterministic algorithms from
    the same init: ``rounds`` eager ``FedSim.round`` calls under
    ``disable_graphs`` and as many through the round's program
    (:func:`round_pair`), then one ``FedSim.run_rounds`` call over the same
    staged rounds (:func:`graph_run`). The final state and every metric
    equal the eager loop's to the bit; the wrappers launch in the call only
    in the warm-up
    (``WARMUP_ROUNDS`` rounds' worth of the loop's launches), the capture
    recorded one round's, and the graph names the hand-written kernels
    ``symbols``. ``seeded``: each round gets a generator seeded with its
    index (randk's draws). ``default_mode``: one more ``run_rounds`` call
    in the default mode, which phase 3's eager rounds are timed in, checked
    as :func:`graph_run` checks and for a finite state (the default mode is
    not bit-reproducible)."""
    from repro_torch.core.sim import WARMUP_ROUNDS
    from repro_torch.kernels import ops
    rounds = len(plan)
    gens = lambda: ([torch.Generator().manual_seed(r) for r in range(rounds)]
                    if seeded else None)
    ids, batches = stacked(plan)
    t_route = time.perf_counter()
    with deterministic():
        pair = round_pair(name, make, plan, seeded)
        st, mets_e = pair["states"][0], pair["mets"][0]
        ms, ev, eager = (pair["eager_ms"], pair["eager_event_ms"],
                         pair["eager"])
        del pair["sims"], pair["states"], pair["mets"]
        sim_g, st_g = make()
        g = graph_run(name, sim_g, st_g, batches, ids, gens(), rounds)
    diff = same_state(st, g["state"])
    bad = [(r, key) for r, (a, b) in enumerate(zip(mets_e, g["mets"]))
           for key in a if key not in b or not _same_metric(a[key], b[key])]
    check(not diff and not bad and len(g["mets"]) == rounds,
          f"run_rounds {name}: differs from the eager loop in {diff}, "
          f"metrics {bad[:6]}")
    for kname in expect:
        check(eager[kname] > 0 and g["graph"][kname] > 0,
              f"run_rounds {name}: {kname} launched {eager[kname]} times "
              f"eagerly, {g['graph'][kname]} through the graph")
    check(all(g["wrapper"][k] * rounds == eager[k] * WARMUP_ROUNDS
              and g["captured"][k] * rounds == eager[k] for k in eager),
          f"run_rounds {name}: the call's launches {g['wrapper']} and its "
          f"capture's {g['captured']} against the loop's {eager} "
          f"(warm-up {WARMUP_ROUNDS}, {rounds} rounds)")
    for kname in symbols:
        check(g["graph"][kname] > 0,
              f"run_rounds {name}: the captured graph has no {kname} kernel")
    runs = [g]
    out = dict(round_program=pair, eager_round_ms=ms[1:],
               eager_round0_ms=ms[0],
               eager_round_event_ms=ev[1:], eager_total_ms=sum(ms),
               graph_replay_ms=g["replay_ms"], run_rounds_call_ms=g["call_ms"],
               syncs_before_replays=g["syncs_before_replays"],
               syncs=g["syncs"], launches_eager=eager,
               launches_graph_call=g["wrapper"],
               graph_kernels=[k for k, n in g["graph"].items() if n],
               loss=[float(m["loss"]) for m in g["mets"]],
               state_sha256=state_digest(g["state"]))
    if default_mode:
        sim_d, st_d = make()
        d = graph_run(f"{name} (default mode)", sim_d, st_d, batches, ids,
                      gens(), rounds)
        loss_d = [float(m["loss"]) for m in d["mets"]]
        check(all(np.isfinite(loss_d)) and all(
            bool(torch.isfinite(t).all()) for t in
            (d["state"].params, d["state"].errors, d["state"].x_client)),
            f"run_rounds {name} (default mode): a state or loss not finite")
        runs.append(d)
        out.update(default_graph_replay_ms=d["replay_ms"],
                   default_run_rounds_call_ms=d["call_ms"],
                   default_loss=loss_d)
    out["launches_wrapper"] = {k: eager[k] + pair["wrapper"][k]
                               + sum(x["wrapper"][k] for x in runs)
                               for k in eager}
    out["launches_in_graph"] = {k: pair["graph"][k]
                                + sum(x["graph"][k] for x in runs)
                                for k in eager}
    out["seconds"] = time.perf_counter() - t_route
    return out


def problem(model: str):
    """``(loss, p0, data, d, cfg)`` of one model: make_problem's
    ``"convmixer"`` or ``"mlp"``, or ConvMixer-256-8 (``"convmixer-256-8"``,
    routes a-l's, on CIFAR-shaped data); weights seeded, data Dirichlet
    α = 0.3 over M clients."""
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import count_params, init_params
    if model == "mlp":
        c = cm.MLPConfig(in_dim=32, hidden=64, depth=2, num_classes=10)
        data = FederatedClassification(num_clients=M, feature_dim=32,
                                       alpha=0.3, seed=0)
        defs, loss = cm.mlp_defs(c), (lambda p, b: cm.mlp_loss(p, b, c))
    else:
        c = (cm.ConvMixerConfig() if model == "convmixer-256-8" else
             cm.ConvMixerConfig(dim=32, depth=4, kernel=5, patch=2,
                                num_classes=10, image=16))
        data = FederatedClassification(
            num_clients=M, image_shape=(c.image, c.image, 3), alpha=0.3,
            seed=0)
        defs, loss = cm.convmixer_defs(c), (
            lambda p, b: cm.convmixer_loss(p, b, c))
    return (loss, init_params(defs, torch.Generator().manual_seed(0)), data,
            count_params(defs), c)


# ---------------------------------------------------------------------------
# the block part: FedSim's local phase, batched, against its loop twin
# ---------------------------------------------------------------------------

#: the blocks: route a's on ConvMixer-256-8 and on make_problem's two models,
#: each n = N_CLI clients, K_STEPS steps, batch BATCH
BLOCK_MODELS = ("convmixer-256-8", "convmixer", "mlp")
#: the batched deltas against the loop's, absolute, per element (the CPU
#: reads 1.49e-8 to 2.98e-8 on make_problem's ConvMixer and 0 on the MLP,
#: tests/test_torch_local_block.py); past it is a fault, not a bound to raise
BLOCK_TOL = 1e-6
BLOCK_ITERS = 3     # timed runs of each form (one more to warm up)


def _block_run(fn, iters: int = BLOCK_ITERS):
    """``fn()``'s output, the CUDA-event ms of ``iters`` runs after one
    warm-up run (each to a synchronize), and the card's peak memory over
    the baseline in GB."""
    out = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(iters):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_block() -> dict:
    """FedSim's local phase, one ``torch.func.vmap`` program over the block
    (``FedSim._train_block``), against ``core.local.train_clients_loop``
    (the clients one after another on the autograd gradient) on the same
    inputs: route a's round-0 block of each of ``BLOCK_MODELS``, under
    deterministic algorithms, then both forms timed in the default mode.
    Fails past ``BLOCK_TOL``; prints the per-client largest difference
    beside the largest |Δ|, whether the two are bitwise equal, each form's
    ms and its peak memory (and, on the ConvMixers, the activations the
    batched block holds, reckoned)."""
    from repro_torch.core.local import autograd_grad_fn, train_clients_loop
    from repro_torch.core.sim import FedSim

    card = card_line()
    med = lambda xs: float(np.median(xs))
    out = {}
    for model in BLOCK_MODELS:
        t0 = time.perf_counter()
        loss, p0, data, d, c = problem(model)
        sim = FedSim(loss, _route_cfg("a", M, N_CLI, K_STEPS))
        flat0 = sim.init(p0).x_client
        _, b = _plan(data, M, 1)[0]
        batches = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
        eta_l = torch.tensor(sim.fed.eta_l, device="cuda")
        grad_fn = autograd_grad_fn(sim.loss_fn, sim.unravel)
        forms = {
            "batched": lambda: sim._train_block(flat0, batches, eta_l),
            "loop": lambda: train_clients_loop(sim.rule, grad_fn, flat0,
                                               batches, eta_l)}
        r = {}
        with deterministic():
            for form, fn in forms.items():
                r[form], r[f"{form}_det_ms"], r[f"{form}_det_gb"] = (
                    _block_run(fn))
        for form, fn in forms.items():
            _, r[f"{form}_ms"], r[f"{form}_gb"] = _block_run(fn)
        (db, lb), (dl, ll) = r.pop("batched"), r.pop("loop")
        err = (db - dl).abs().amax(dim=1).tolist()
        big = dl.abs().amax(dim=1).tolist()
        bitwise = torch.equal(db, dl) and torch.equal(lb, ll)
        check(db.shape == (N_CLI, d) and bool(torch.isfinite(db).all()),
              f"block {model}: deltas {tuple(db.shape)} or not finite")
        check(max(err) <= BLOCK_TOL, f"block {model}: the batched deltas "
              f"differ from the loop's by {max(err)} > {BLOCK_TOL}")
        r.update(d=d, max_abs_err=err, max_abs_delta=big, bitwise=bitwise,
                 loss_max_abs_err=float((lb - ll).abs().max()))
        saved = ""
        if model != "mlp":
            # the (B, dim, H/p, W/p) fp32 tensors autograd keeps a client:
            # 6 a layer (the depthwise conv's input, both GELUs' inputs and
            # outputs, the 1x1 conv's input) and the patch GELU's input
            side = c.image // c.patch
            r["reckoned_gb"] = (N_CLI * (6 * c.depth + 1) * BATCH * c.dim
                                * side * side * 4 / 1e9)
            saved = (f", reckoned activations of the batched block "
                     f"{r['reckoned_gb']:.3f} GB")
        r["seconds"] = time.perf_counter() - t0
        out[model] = r
        print(f"block {model} (d = {d:,}, n = {N_CLI}, K = {K_STEPS}, batch "
              f"{BATCH}): batched vs loop, deterministic algorithms, largest "
              f"|Δ_batched − Δ_loop| a client "
              f"{[f'{e:.3g}' for e in err]} beside largest |Δ| "
              f"{[f'{e:.3g}' for e in big]} (bound {BLOCK_TOL}); bitwise "
              f"{bitwise}; ms (CUDA events, median of {BLOCK_ITERS}) batched "
              f"{med(r['batched_det_ms']):.3f} / loop "
              f"{med(r['loop_det_ms']):.3f} deterministic, batched "
              f"{med(r['batched_ms']):.3f} / loop {med(r['loop_ms']):.3f} "
              f"default mode; peak over the baseline batched "
              f"{r['batched_gb']:.3f} GB / loop {r['loop_gb']:.3f} GB"
              f"{saved}; {r['seconds']:.1f} s; {card}")
        del sim, flat0, batches, db, dl
        torch.cuda.empty_cache()
    return out


def phase_run_rounds(loss, p0, data, d: int, res: dict) -> dict:
    """Routes ``GRAPH_ROUTES`` on ConvMixer-256-8 at ``GRAPH_ROUNDS`` rounds;
    make_problem's ConvMixer and MLP at ``PROBLEM_ROUNDS`` on route a's
    configuration; and, for the capture of the other round paths (the
    dense codecs' packing, the two-way downlink, the dense top-k EF, sign
    with faults), routes ``MLP_ROUTES`` on the MLP at ``MLP_ROUNDS``. Each
    through :func:`run_rounds_route`, ``DEFAULT_MODE_ROUTES`` also in the
    default mode. ``res``: phase 3's routes, whose configuration and rounds
    the ConvMixer-256-8 routes take, and whose eager round ms (default
    mode) the default-mode graph is printed beside."""
    from repro_torch.core.sim import FedSim

    card = card_line()
    out = {}
    jobs = []   # (key, label, loss, p0, FedConfig, plan, kernels, symbols)
    for route in GRAPH_ROUTES:
        plan = _plan(data, M, GRAPH_ROUNDS)
        cfg = _route_cfg(route, M, N_CLI, K_STEPS, route_fault(
            route, plan, M, N_CLI, K_STEPS, d, loss, p0, "cuda"))
        jobs.append((route, route, loss, p0, cfg, plan, EXPECT[route],
                     GRAPH_SYMBOLS.get(route, ())))
    for model in PROBLEMS:
        ploss, pp0, pdata, pd, _ = problem(model)
        jobs.append((model, f"{model} (make_problem, d = {pd:,})", ploss,
                     pp0, _route_cfg("a", M, N_CLI, K_STEPS),
                     _plan(pdata, M, PROBLEM_ROUNDS), EXPECT["a"],
                     GRAPH_SYMBOLS["a"]))
    for route in MLP_ROUTES:        # the MLP's, the last model above
        plan = _plan(pdata, M, MLP_ROUNDS)
        fault = route_fault(route, plan, M, N_CLI, K_STEPS, pd, ploss, pp0,
                            "cuda")
        jobs.append((f"mlp {route}", f"route {route} on the MLP", ploss, pp0,
                     _route_cfg(route, M, N_CLI, K_STEPS, fault), plan,
                     EXPECT[route], GRAPH_SYMBOLS.get(route, ())))
    med = lambda xs: float(np.median(xs))
    for key, label, jl, jp0, cfg, plan, expect, symbols in jobs:
        def make(jl=jl, jp0=jp0, cfg=cfg):
            sim = FedSim(jl, cfg)
            return sim, sim.init(jp0)
        r = run_rounds_route(key, make, plan, expect, symbols,
                             seeded=key == "l",
                             default_mode=key in DEFAULT_MODE_ROUTES)
        out[key] = r
        r["round_program"] = round_pair_line(label, r["round_program"], card)
        n = len(plan)
        print(f"run_rounds {label}, deterministic algorithms, {n} rounds: "
              f"eager round ms (round 0 excluded) median "
              f"{med(r['eager_round_ms']):.3f} on the host's clock "
              f"{[round(t, 3) for t in r['eager_round_ms']]}, "
              f"{med(r['eager_round_event_ms']):.3f} by CUDA events; the "
              f"graph's replay ms (CUDA events) median "
              f"{med(r['graph_replay_ms']):.3f} "
              f"{[round(t, 3) for t in r['graph_replay_ms']]}, "
              f"{med(r['eager_round_event_ms']) / med(r['graph_replay_ms']):.2f}"
              f"x by events; whole: {n} eager rounds "
              f"{r['eager_total_ms']:.1f} ms against the run_rounds call "
              f"{r['run_rounds_call_ms']:.1f} ms (staging, warm-up, "
              f"capture, replays, one read), "
              f"{r['eager_total_ms'] / r['run_rounds_call_ms']:.2f}x; one "
              f"capture, {n} replays, no sync between them and one after "
              f"({r['syncs_before_replays']} before); state and metrics = "
              f"the eager loop's to the bit; graph kernels "
              f"{r['graph_kernels']}; {r['seconds']:.1f} s; {card}")
        if "default_graph_replay_ms" in r:
            eager_ms = res[key]["round_ms"][:n - 1]
            print(f"run_rounds {label}, default mode, {n} rounds: the "
                  f"graph's replay ms (CUDA events) median "
                  f"{med(r['default_graph_replay_ms']):.3f} "
                  f"{[round(t, 3) for t in r['default_graph_replay_ms']]}; "
                  f"phase 3's round ms through the round's program (host "
                  f"clock, round 0 excluded) median {med(eager_ms):.3f}; "
                  f"the run_rounds call "
                  f"{r['default_run_rounds_call_ms']:.1f} ms against "
                  f"phase 3's {n} round calls "
                  f"{res[key]['round0_ms'] + sum(eager_ms):.1f} ms; {card}")
    return out


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
    res, starts = {}, []
    for route in routes:
        starts.append((route, time.perf_counter()))
        if route == "g":
            res[route] = route_g(loss, p0, data, d, rounds)
            r = res[route]
            print(f"route g: round ms through the round's program "
                  f"(round 0 excluded) "
                  f"{[round(t, 2) for t in r['round_ms']]}, median "
                  f"{np.median(r['round_ms']):.2f}; loss {r['loss']}; "
                  f"the graph's launches "
                  f"{ {k: n for k, n in r['graph_launches'].items() if n} }"
                  f", the wrappers' {r['launches']}; checkpoints "
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
            graph = {k: n for k, n in r["graph_launches"].items() if n}
            print(f"route {route}: {timing} (through the programs); loss "
                  f"{r['loss']}; the graphs' launches {graph}, the "
                  f"wrappers' (the warm-ups) {r['launches']}; final state "
                  f"sha256 {r['state_sha256']}")
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
        verdicts = []
        torch.cuda.synchronize()
        ops.reset_launches()
        ms, losses, gammas, wire = [], [], [], []
        for idx, b in plan:
            if fault is not None:
                rows = torch.as_tensor(idx, device="cuda")
                before = (rows, st.errors[rows])
                fplan, _ = sim.faults.plan(idx, st.round,
                                           sim._round_timing(idx, st.round))
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
        # the rounds replayed the round's program: its launches are its
        # graph's nodes times the replays; the wrappers', its warm-up's
        graph = round_launches(f"route {route}", sim, rounds, counts)
        check(len(sim._programs) == 1, f"route {route}: "
              f"{len(sim._programs)} round programs")
        for name in EXPECT[route]:
            check(graph[name] > 0, f"route {route}: {name} never launched")
        if fault is not None:
            check(graph["fedams_ingest"] == 0,
                  f"route {route}: fedams_ingest launched under faults")
            for name in EXPECT[route]:
                check(graph[name] == rounds, f"route {route}: {name} "
                      f"launched {graph[name]} times in {rounds} rounds")
        # the dense wire routes encode the (n, d) block: one launch of each
        # a round for all n clients (route h's sparse fp32 wire skips the
        # byte shuffle: its selections go through as what decoding gives)
        packed = sim.codec is not None and not sim.sparse
        if packed:
            check(graph["pack_uint"] == rounds and
                  graph["unpack_uint"] == rounds,
                  f"route {route}: pack_uint/unpack_uint launched "
                  f"{graph['pack_uint']}/{graph['unpack_uint']} times in "
                  f"{rounds} rounds")
            nbytes = sim.codec.nbytes(d)
            # the codec encodes in the warm-up and the capture: the
            # replays run what they recorded
            check(len(sizes) == 2 * N_CLI and set(sizes) == {nbytes},
                  f"route {route}: encoded buffer sizes {sorted(set(sizes))}"
                  f" over {len(sizes)} messages, codec.nbytes(d)={nbytes}")
        # the host counters, booked after each replay as after an eager
        # round, and the state the program hands back
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
                          gamma=gammas, launches=counts,
                          graph_launches=graph, wire=wire,
                          ef_buffer_mb=st.errors.numel() * 4 / 1e6,
                          state_sha256=state_digest(st))
        if fault is not None:
            res[route].update(fault=dataclasses.asdict(fault),
                              verdicts=verdicts)
            print(f"route {route}: {fault}; verdicts {VERDICTS} per round "
                  f"{[list(v.values()) for v in verdicts]}")
        if route == "i":
            # the payloads' norms, read on the host as each round
            # validates them: the eager rounds of the same configuration
            norms = []
            twin = FedSim(loss, _route_cfg(route, M, N_CLI, K_STEPS, fault))
            st_i = twin.init(p0)
            with recording_norms(norms), disable_graphs():
                for idx, b in plan:
                    st_i, _ = twin.round(st_i, b, idx)
            del twin, st_i
            cap = fault.max_update_norm
            seen = torch.cat(norms)
            share = float((seen > cap).float().mean())
            check(0 < share, f"route i: no payload clipped at {cap}")
            res[route].update(clip_norm=cap, clipped_share=share)
            print(f"route i: clip norm {cap:.6g}, {share:.3f} of "
                  f"{seen.numel()} validated payloads clipped")
        print(f"route {route}: round ms through the round's program (host "
              f"clock; round 0, with its warm-up and capture, excluded) "
              f"{[round(t, 2) for t in ms[1:]]}, median "
              f"{np.median(ms[1:]):.2f}; loss {losses}; the graph's launches "
              f"{ {k: n for k, n in graph.items() if n} }, the wrappers' "
              f"(the warm-up) {counts}; final state sha256 "
              f"{res[route]['state_sha256']}")
    t0 = time.perf_counter()
    res["route_s"] = {route: t1 - t for (route, t), (_, t1) in zip(
        starts, starts[1:] + [("", t0)])}
    print(f"phase 3's seconds by route "
          f"{ {k: round(v, 1) for k, v in res['route_s'].items()} }")
    res["run_rounds"] = phase_run_rounds(loss, p0, data, d, res)
    res["run_rounds_s"] = time.perf_counter() - t0
    print(f"phase 3's run_rounds part took {res['run_rounds_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# route m: the mesh backend, four ranks sharing the card over gloo; m1: one
# NCCL rank
# ---------------------------------------------------------------------------

M_MESH = 4          # route m's ranks, one client each
ANCHOR_ROUNDS = 3   # the flat model's rounds held to FedSim's to the bit
#: the per-leaf jobs' rounds (6 took 3.9-5.2 s a job; the script's time),
#: but for ``faults``, which keeps ROUNDS: its seeded plan first rejects
#: a payload in its fourth round
LEAF_ROUNDS = 3
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
    leaf = dict(shape=(M_MESH,), axes=("data",), flat=False,
                rounds=LEAF_ROUNDS, det=False, gather=False)
    return {
        "anchor-fused": dict(flat, cfg={}, expect={"topk_ef_sparse": 1,
                                                   "fedams_ingest": 1}),
        "anchor-twopass": dict(flat, cfg=dict(fused_ingest="off"),
                               expect={"topk_ef_sparse": 1,
                                       "fedams_update": 1}),
        # anchor-fused's rounds as one call of build_fed_rounds_scan: on
        # gloo its staged body, run eagerly, equal to the loop to the bit
        "anchor-program": dict(flat, cfg={}, program=True,
                               expect={"topk_ef_sparse": 1,
                                       "fedams_ingest": 1}),
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
        "faults": dict(leaf, rounds=ROUNDS, cfg=dict(fault=FaultConfig(
            crash_prob=0.25, corrupt_prob=0.25)), expect=per_leaf(
                kernels=("topk_ef_sparse", "fedams_update"))),
        # the user's entry point: FederatedTrainer(mesh=...).run
        "trainer": dict(leaf, cfg={}, rounds=ANCHOR_ROUNDS, trainer=True,
                        expect=per_leaf(kernels=("topk_ef_sparse",
                                                 "fedams_ingest"))),
    }


def _mesh_setup(job: dict):
    """A mesh job's parts on this rank: its ``FedConfig``, the model (the
    flat one or the per-leaf tree), ``lm_data``, the mesh and context, the
    ``TrainConfig``, the round built with a CUDA KernelImpl, and
    ``init()``, a fresh initial state on the card (the same each call)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import mesh as meshmod
    from repro_torch.data.synthetic import FederatedClassification
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import init_params, ravel
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

    def init():
        state = meshmod.init_fed_state(model, fed,
                                       torch.Generator().manual_seed(0), ctx,
                                       "cuda")
        if job["flat"]:
            state = state._replace(params={"w": flat0.clone()})
        return state

    return fed, model, data, mesh, ctx, train, rnd, init


def _mesh_job(job: dict) -> dict:
    """One mesh run on this rank: build the round with a CUDA KernelImpl,
    stage its batches, then — launch counters at 0 — drive ``rounds``
    rounds and read the counters. Returns the per-round metrics, round ms,
    the launches, the wire bytes ``mesh_wire_bytes_tiers`` bills, and
    (``gather``) the global state. With ``program`` the rounds are one
    call of ``build_fed_rounds_scan`` (on gloo its staged body runs
    eagerly, round by round; ``captured`` says which ran)."""
    import torch.distributed as dist

    from repro_torch.core import mesh as meshmod
    from repro_torch.kernels import ops
    from repro_torch.models.params import tree_leaves

    fed, model, data, mesh, ctx, train, rnd, init = _mesh_setup(job)
    m = fed.num_clients
    state = init()
    if job.get("trainer"):
        return _trainer_job(job, fed, model, data, mesh, train)
    raws = [data.mesh_batch(r, K_STEPS, m * BATCH, 1)
            for r in range(job["rounds"])]
    batches = [meshmod.shard_batch(raw, model, fed, train, ctx, "cuda")
               for raw in raws]
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
        if job.get("program"):
            scan = meshmod.build_fed_rounds_scan(rnd)
            staged = meshmod.shard_batch(
                {k: np.stack([raw[k] for raw in raws]) for k in raws[0]},
                model, fed, train, ctx, "cuda", staged=True)
            t0 = time.perf_counter()
            state, stacked = scan(state, staged, list(range(len(raws))))
            torch.cuda.synchronize()
            res["round_ms"] = [(time.perf_counter() - t0) * 1e3 / len(raws)]
            res["captured"] = scan.last["captured"]
            for k, col in stacked.items():
                res[k] = [float(v) for v in col]
            batches = []
            del scan
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
    ``outdir/rank{rank}.pt``; each job's result also holds its seconds
    (``"job_s"``)."""
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
            t0 = time.perf_counter()
            out[name] = fn(job)
            out[name]["job_s"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            free, _ = torch.cuda.mem_get_info()
            out[name]["after_gb"] = (free / 1e9,
                                     torch.cuda.memory_reserved() / 1e9)
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
    ANCHOR_ROUNDS rounds under deterministic algorithms.

    The mesh trains one client a rank, as the reference's does; FedSim's
    batched local phase, one vmap program over the four, runs cuDNN's
    grouped convolution, whose deterministic algorithm is not the
    per-client one's: its deltas differ from the loop's in the last bits
    (the block part holds them within BLOCK_TOL; a probe read params
    1.0e-5 apart after 3 rounds). So on this instance alone the local
    phase is the loop twin, and the anchor holds the mesh's uplink,
    collectives and server step to FedSim's to the bit."""
    from repro_torch.core.local import autograd_grad_fn, train_clients_loop
    from repro_torch.core.sim import FedSim
    fed = mesh_cfg(client_axes=(), track_gamma=not fused, wire_block=BLOCK)
    sim = FedSim(loss, fed)
    check(sim._fused == ("kernel" if fused else "off"),
          f"route m anchor: FedSim resolved fused_ingest={sim._fused}")
    st = sim.init(p0)
    grad_fn = autograd_grad_fn(sim.loss_fn, sim.unravel)
    sim._train_block = lambda flat0, batches, eta_l, k_blk=None: \
        train_clients_loop(sim.rule, grad_fn, flat0, batches, eta_l, k_blk)
    ids = np.arange(M_MESH)
    losses = []
    # eager rounds (``disable_graphs``), as the mesh's own rounds run here
    with deterministic(), disable_graphs():
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
    t0 = time.perf_counter()
    ranks = shared_ranks("gloo4", "m")
    ranks_s = time.perf_counter() - t0
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
              f"shapes, each held by phase 1: {n_shapes}; {job['rounds']} "
              f"rounds, the job {r0['job_s']:.1f} s on rank 0")
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
    prog, loop = ranks[0]["anchor-program"], ranks[0]["anchor-fused"]
    bad = [f for f in loop["state"] if not torch.equal(
        prog["state"][f]["w"].view(torch.int32),
        loop["state"][f]["w"].view(torch.int32))]
    check(all(rk["anchor-program"]["captured"] is False for rk in ranks)
          and not bad and prog["loss"] == loop["loss"],
          f"route m anchor-program: captured "
          f"{[rk['anchor-program']['captured'] for rk in ranks]}; differs "
          f"from the loop in {bad}; losses {prog['loss']} vs {loop['loss']}")
    res["anchor-program"]["equals_loop"] = True
    print(f"route m anchor-program: {ANCHOR_ROUNDS} rounds through "
          f"build_fed_rounds_scan on gloo (the staged body run eagerly, "
          f"captured: False on all {M_MESH} ranks) equal anchor-fused's loop "
          f"to the bit (params, m, v, v-hat, the EF rows, losses)")
    print(f"route m: its jobs {sum(r['job_s'] for r in ranks[0].values()):.1f}"
          f" s on rank 0 of the {M_MESH} ranks (their group's start: "
          f"{ranks_s:.1f} s), the FedSim anchors "
          f"{time.perf_counter() - t0 - ranks_s:.1f} s")
    return res


def m1_job() -> dict:
    """Route m1's job: route m's sparse per-leaf round at one client (its
    last round profiled: the NCCL kernels on the card)."""
    return dict(mesh_jobs()["sparse-3of4"], cfg=dict(num_clients=1),
                shape=(1,), rounds=ANCHOR_ROUNDS, profile_last=1,
                expect={"topk_ef_sparse": LEAVES, "fedams_ingest": LEAVES})


#: the rounds route m1's rounds run through build_fed_rounds_scan, in
#: each mode (eager loop, then one program call)
M1_GRAPH_ROUNDS = ROUNDS
#: the two modes the mesh programs (m1, o1) run in: bitwise the eager loop
#: under deterministic algorithms; timed in both
GRAPH_MODES = ("deterministic", "default")


def m1_graph_job() -> dict:
    """Route m1's rounds through the program (:func:`_mesh_graph_job`)."""
    return dict(m1_job(), rounds=M1_GRAPH_ROUNDS, fn=_mesh_graph_job)


def _differs(a, b) -> list:
    """The fields of two mesh states (on the card) that differ in any bit."""
    from repro_torch.models.params import tree_leaves
    return [f for f in ("params", "m", "v", "vhat", "errors", "round")
            if not all(torch.equal(x.reshape(-1).view(torch.uint8),
                                   y.reshape(-1).view(torch.uint8))
                       for x, y in zip(tree_leaves(getattr(a, f)),
                                       tree_leaves(getattr(b, f))))]


def _graph_checks(label, scan, spy, rounds: int, whole: bool) -> dict:
    """A mesh program's call (``core.mesh.build_fed_rounds_scan``) under
    :func:`graph_spy`, checked: it captured (decided up front, and
    reported), once, and replayed ``rounds`` times with no synchronizing
    CUDA operation between the first replay and the last; with ``whole``
    (the spy around the program's call alone) exactly one after them, the
    metrics' read. Its graph's kernel nodes (:func:`graph_census`) are one for
    each launch its capture recorded. Returns the replays' ms, the nodes
    and the sync counts."""
    prog = scan.last["program"]
    replay_ms = [e0.elapsed_time(e1) for e0, e1 in spy["events"]]
    check(scan.last["captured"] and scan.last["built"]
          and spy["captures"] == 1 and len(replay_ms) == rounds,
          f"{label}: captured {scan.last['captured']}, {spy['captures']} "
          f"captures, {len(replay_ms)} replays for {rounds} rounds")
    at = spy["syncs_before"]
    after = spy["syncs"] - at[-1]
    check(at[-1] == at[0] and (after == 1 if whole else after >= 1),
          f"{label}: synchronizing CUDA operations counted {at} at the "
          f"replays and {spy['syncs']} in all; none between the replays "
          f"and {'one' if whole else 'some'} after them expected")
    nodes = graph_census(prog.graph)[1]
    check(nodes == dict(prog.counts), f"{label}: the graph's kernel nodes "
          f"{nodes} against the capture's launches {dict(prog.counts)}")
    return dict(replay_ms=replay_ms, nodes=nodes, syncs=spy["syncs"],
                syncs_before_replays=at[0])


def _mesh_graph_job(job: dict) -> dict:
    """Route m1's rounds through ``build_fed_rounds_scan`` on this NCCL
    rank, in each of :data:`GRAPH_MODES`: ``rounds`` eager ``fed_round``
    calls from the init (each timed on the host to a synchronize, and by
    CUDA events), then from the same init one program call (one round
    captured into a CUDA graph after a warm-up round, replayed ``rounds``
    times: :func:`_graph_checks`), timed on the host to a synchronize.
    Under deterministic algorithms the program's state and every metric
    equal the loop's to the bit. Returns, by mode, the times, the wrappers'
    launches (the loop's; the call's: the warm-up's) and the graph's kernel
    nodes."""
    from repro_torch.core import mesh as meshmod
    from repro_torch.kernels import ops

    fed, model, data, mesh, ctx, train, rnd, init = _mesh_setup(job)
    m, R = fed.num_clients, job["rounds"]
    raws = [data.mesh_batch(r, K_STEPS, m * BATCH, 1) for r in range(R)]
    batches = [meshmod.shard_batch(raw, model, fed, train, ctx, "cuda")
               for raw in raws]
    staged = meshmod.shard_batch(
        {k: np.stack([raw[k] for raw in raws]) for k in raws[0]}, model,
        fed, train, ctx, "cuda", staged=True)
    out = {}
    for mode in GRAPH_MODES:
        with (deterministic() if mode == "deterministic"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            ops.reset_launches()
            st, mets, ms, ev = init(), [], [], []
            t_loop = time.perf_counter()
            for r, b in enumerate(batches):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                st, met = rnd(st, b, r)
                e1.record()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                ev.append(e0.elapsed_time(e1))
                mets.append(met)
            loop_ms = (time.perf_counter() - t_loop) * 1e3
            eager = dict(ops.launches)
            scan = meshmod.build_fed_rounds_scan(rnd)
            st0 = init()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            with graph_spy() as spy:
                st_g, stacked = scan(st0, staged, list(range(R)))
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
            wrapper = dict(ops.launches)
            g = _graph_checks(f"route m1 graph ({mode})", scan, spy, R, True)
        if mode == "deterministic":
            bad = _differs(st, st_g)
            badm = [(k, r) for k, col in stacked.items() for r in range(R)
                    if not torch.equal(col[r].view(torch.int32), mets[r][
                        k].detach().cpu().reshape(()).view(torch.int32))]
            check(not bad and not badm, f"route m1 graph: differs from the "
                  f"eager loop in {bad}, metrics {badm}")
            with deterministic():
                out["per_round"] = _mesh_per_round(
                    "route m1", meshmod.build_fed_rounds_scan(rnd), init(),
                    batches, st, mets)
        out[mode] = dict(
            g, eager_round_ms=ms, eager_event_ms=ev, eager_loop_ms=loop_ms,
            call_ms=call_ms, eager_launches=eager, wrapper_launches=wrapper,
            loss=[float(v) for v in stacked["loss"]],
            eager_loss=[float(mt["loss"]) for mt in mets],
            captured=scan.last["captured"])
        del st, st_g, st0, mets, scan, stacked
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mesh_per_round(label, step, st0, batches, want, want_mets) -> dict:
    """The mesh's per-round step, as the trainer and ``train`` take it:
    ``len(batches)`` calls of ``MeshRounds.round`` (``step``) from ``st0``,
    one program at R = 1 kept across them, under :func:`graph_spy`: one
    capture, a replay a call (each timed by CUDA events; each call on the
    host's clock to a synchronize), the graph's kernel nodes its capture's
    launches; the state (``want``) and every round's metrics
    (``want_mets``) those of the eager ``fed_round`` loop to the bit.
    Returns the numbers."""
    from repro_torch.kernels import ops
    st, ms, mets = st0, [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    with graph_spy() as spy:
        for r, b in enumerate(batches):
            t0 = time.perf_counter()
            st, met = step.round(st, b, r)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append(met)
    wrapper = dict(ops.launches)
    replay = [e0.elapsed_time(e1) for e0, e1 in spy["events"]]
    prog = step.last["program"]
    check(step.last["captured"] and len(step.programs) == 1
          and spy["captures"] == 1 and len(replay) == len(batches),
          f"{label} per-round step: captured {step.last['captured']}, "
          f"{len(step.programs)} programs, {spy['captures']} captures, "
          f"{len(replay)} replays for {len(batches)} calls")
    nodes = graph_census(prog.graph)[1]
    check(nodes == {k: prog.counts.get(k, 0) for k in nodes},
          f"{label} per-round step: the graph's kernel nodes {nodes} "
          f"against the capture's launches {dict(prog.counts)}")
    bad = _differs(want, st)
    badm = [(k, r) for r, (a, b) in enumerate(zip(want_mets, mets))
            for k in a if not torch.equal(
                a[k].detach().cpu().reshape(()).view(torch.int32),
                b[k].reshape(()).view(torch.int32))]
    check(not bad and not badm, f"{label} per-round step: differs from the "
          f"eager loop in {bad}, metrics {badm}")
    return dict(replay_ms=replay, call_ms=ms, nodes=nodes,
                wrapper_launches=wrapper, captures=spy["captures"],
                programs=len(step.programs), bitwise=True)


def per_round_line(route: str, p: dict, eager_event_ms, eager_ms,
                   card: str) -> None:
    """Print a :func:`_mesh_per_round`'s line beside the eager loop's
    CUDA-event and host-clock ms a round (round 0 excluded)."""
    med = lambda xs: float(np.median(xs[1:] if len(xs) > 1 else xs))
    print(f"route {route} per-round step (MeshRounds.round), deterministic "
          f"algorithms, {len(p['replay_ms'])} calls: programs built "
          f"{p['programs']}, captures {p['captures']}; the replay ms (CUDA "
          f"events) {[round(t, 3) for t in p['replay_ms']]} (median "
          f"{float(np.median(p['replay_ms'])):.3f}) beside the eager "
          f"round's {med(eager_event_ms):.3f} by events; a call on the "
          f"host's clock median {med(p['call_ms']):.3f} ms (call 0, with "
          f"the warm-up and the capture, {p['call_ms'][0]:.1f}) beside the "
          f"eager round's {med(eager_ms):.3f}; kernel nodes "
          f"{ {k: n for k, n in p['nodes'].items() if n} }; state and "
          f"metrics bitwise the eager loop's; {card}")


def route_m1(held) -> dict:
    """Route m1: the sparse fused per-leaf round on ONE NCCL rank (NCCL
    refuses two ranks on one card): the production backend starts, and
    the profiler sees its collectives run on the card. Every shape a
    kernel is launched at is held by phase 1 (``held``)."""
    job = m1_job()
    r0 = shared_ranks("nccl1", "m1")[0]["m1"]
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
          f"{[round(t, 1) for t in r0['round_ms']]}; the job {r0['job_s']:.1f}"
          f" s")
    r0["graph"] = graph_report("m1", shared_ranks("nccl1", "m1")[0]["graph"],
                               job["expect"], M1_GRAPH_ROUNDS, held)
    r0["launches"] = {k: v + r0["graph"]["launches"][k]
                      for k, v in r0["launches"].items()}
    return r0


def graph_report(route: str, g: dict, expect: dict, rounds: int,
                 held) -> dict:
    """Check and print a mesh program job's result (:func:`_mesh_graph_job`
    or :func:`_o1_job`), mode by mode: the wrappers launch ``expect`` a
    round in the eager loop and one round's worth in the program's call
    (its warm-up); the graph holds one node of each kernel a launch of one
    round; every launch shape held by phase 1. Returns the result with
    ``launches`` (the wrappers', both modes) and ``graph_launches`` (the
    graphs' nodes × replays), kept apart."""
    shapes = g.pop("shapes")
    g["shapes_held"] = check_shapes_held(f"{route} graph",
                                         [{"shapes": shapes}], held)
    card = card_line()
    launches = {k: 0 for k in KERNEL_SYMBOLS}
    in_graph = {k: 0 for k in KERNEL_SYMBOLS}
    for mode in GRAPH_MODES:
        r = g[mode]
        want = {k: expect.get(k, 0) for k in KERNEL_SYMBOLS}
        check({k: r["eager_launches"].get(k, 0) for k in KERNEL_SYMBOLS}
              == {k: n * rounds for k, n in want.items()}
              and {k: r["wrapper_launches"].get(k, 0)
                   for k in KERNEL_SYMBOLS} == want
              and {k: r["nodes"].get(k, 0) for k in KERNEL_SYMBOLS} == want,
              f"route {route} graph ({mode}): launches a round {want} "
              f"expected; the loop's {r['eager_launches']}, the call's "
              f"{r['wrapper_launches']}, the graph's nodes {r['nodes']}")
        check(all(np.isfinite(r["loss"])),
              f"route {route} graph ({mode}): losses {r['loss']}")
        for k in KERNEL_SYMBOLS:
            launches[k] += (r["eager_launches"].get(k, 0)
                            + r["wrapper_launches"].get(k, 0))
            in_graph[k] += r["nodes"].get(k, 0) * len(r["replay_ms"])
        med = lambda xs: float(np.median(xs[1:] if len(xs) > 1 else xs))
        print(f"route {route} graph, {mode}: eager round ms (host clock, "
              f"rounds 1..) {[round(t, 3) for t in r['eager_round_ms'][1:]]}"
              f", by CUDA events {[round(t, 3) for t in r['eager_event_ms']]}"
              f" (median of 1.. {med(r['eager_event_ms']):.3f}); the graph's"
              f" replay ms {[round(t, 3) for t in r['replay_ms']]} (median "
              f"{float(np.median(r['replay_ms'])):.3f}); whole: the eager "
              f"loop {r['eager_loop_ms']:.1f} ms vs the program's call "
              f"{r['call_ms']:.1f} ms (staging, warm-up, capture, "
              f"{len(r['replay_ms'])} replays, one read); kernel nodes "
              f"{ {k: n for k, n in r['nodes'].items() if n} }; "
              f"{'state and metrics bitwise the loop' if mode == 'deterministic' else 'losses finite'}"
              f"; {card}")
    p = g.get("per_round")
    if p is not None:
        r = g["deterministic"]
        per_round_line(route, p, r["eager_event_ms"], r["eager_round_ms"],
                       card)
        want = {k: expect.get(k, 0) for k in KERNEL_SYMBOLS}
        check({k: p["nodes"].get(k, 0) for k in KERNEL_SYMBOLS} == want
              and {k: p["wrapper_launches"].get(k, 0)
                   for k in KERNEL_SYMBOLS} == want,
              f"route {route} per-round step: launches a round {want} "
              f"expected; the calls' {p['wrapper_launches']}, the graph's "
              f"nodes {p['nodes']}")
        for k in KERNEL_SYMBOLS:
            launches[k] += p["wrapper_launches"].get(k, 0)
            in_graph[k] += p["nodes"].get(k, 0) * len(p["replay_ms"])
    g.update(launches=launches, graph_launches=in_graph)
    return g



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


#: the tokens of a serving route's eager twin (``serve_route``): its first
#: run's first TWIN_GEN tokens, the decode timed over TWIN_GEN - 1 steps
TWIN_GEN = 8
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


def serve_programs(route: str, label: str, sess, gen: int) -> dict:
    """What a run's session did: captured (on the card, one prefill and
    one decode graph), one capture each, one prefill replay and ``gen`` - 1
    decode replays; the decode graph's kernel nodes."""
    check(sess is not None and sess.captured and sess.captures == 2
          and sorted(sess.graphs) == ["decode", "prefill"]
          and sess.replays == {"prefill": 1, "decode": gen - 1},
          f"route {route} {label}: the serving programs ran "
          f"{None if sess is None else (sess.captured, sess.captures, sess.replays)}"
          f", not one capture each, a prefill replay and {gen - 1} decode "
          f"replays")
    nodes = graph_census(sess.graphs["decode"])[0].get("kernel", 0)
    check(nodes > 0, f"route {route} {label}: the decode graph has no "
          f"kernel node")
    return {"captures": sess.captures, "replays": dict(sess.replays),
            "decode_kernel_nodes": nodes,
            "decode_nodes_x_replays": nodes * sess.replays["decode"]}


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


def serve_route(route: str, cfg, generator, runs=None,
                twin: bool = True) -> dict:
    """``cfg`` served through ``launch/serve.py``: ``serve`` on the first of
    ``runs`` ((batch, prompt, gen, q-chunk); default ``SERVE_RUNS``: batch
    4, prompt 512, gen 32; weights from ``generator``), then ``generate`` on
    the same weights for each other run (``SERVE_RUNS``: batch 1, a
    4,608-token prompt, gen 16, q-chunk 256), back to back. Each run goes
    through its session's programs (:func:`serve_programs`: a prefill and a
    decode capture, a replay a token), the configuration's one session:
    a run takes the session of the run before it, its pool and carry, with
    no ``clear_caches()`` between them, and prints its peak allocated and
    reserved. With ``twin`` the first run is then held to its eager twin
    under ``repro_torch.disable_graphs()`` (the same prompts, ``TWIN_GEN``
    tokens: those tokens and the prefill's logits to the bit), its decode
    ms a token and peak beside the program's. Tokens in range, logits
    finite, each run's peak memory beside ``serve_reckoning``'s; the
    port's kernels launch no time; ``repro_torch.clear_caches()`` before
    the route, before the twin and after the route. Returns the runs'
    numbers and the params."""
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.programs import programs_of
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params

    runs = runs or SERVE_RUNS
    model = Model(cfg)
    # every Model of cfg shares these, serve()'s own included
    progs = programs_of(model)
    d = count_params(model.defs())
    res = {"params": d, "num_params_config": cfg.num_params(),
           "reckoned_peak_gb": {b: serve_reckoning(model, d, b, s + g)
                                for b, s, g, _ in runs}}
    print(f"route {route}: {cfg.name}, {cfg.num_layers} layers, {d:,} params "
          f"(ModelConfig.num_params() reads {cfg.num_params():,}), "
          f"{4 * d / 1e9:.2f} GB fp32; reckoned peak "
          f"{res['reckoned_peak_gb']} GB")

    def fresh():
        repro_torch.clear_caches()
        gc.collect()
        torch.cuda.empty_cache()

    ops.reset_launches()
    params = first = None
    fresh()
    for i, (batch, prompt, gen, chunk) in enumerate(runs):
        label, key = f"b{batch} s{prompt}", f"batch {batch}, prompt " \
            f"{prompt}, gen {gen}"
        torch.cuda.reset_peak_memory_stats()
        if i == 0:
            out = tserve.serve(cfg, batch=batch, prompt_len=prompt,
                               gen=gen, device="cuda", generator=generator)
            params = out.pop("params")
            first = (label, key, batch, gen, chunk, out)
            res["init_s"] = out["init_s"]
            print(f"route {route}: the weights drawn in "
                  f"{out['init_s']:.1f} s")
        else:
            prompts = np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(batch, prompt)).astype(np.int32)
            out = tserve.generate(model, params, prompts, gen, chunk=chunk)
        run = _serve_summary(out, batch, gen,
                             torch.cuda.max_memory_allocated(),
                             cfg.vocab_size)
        run["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
        run["programs"] = serve_programs(route, label, progs.live, gen)
        SERVED.setdefault(route, (out["logits0"], out["tokens"]))
        check(run["tokens_in_range"] and run["finite"],
              f"route {route} {label}: tokens out of range or "
              f"logits not finite: {run}")
        res[key] = run
        pr = run["programs"]
        print(f"route {route}: batch {batch}, prompt {prompt}, gen {gen}, "
              f"q-chunk {chunk}: prefill {run['prefill_ms']:.1f} ms (warm-up "
              f"+ 2 captures + replay), decode {run['decode_ms_per_token']:.2f}"
              f" ms/token, {run['tokens_per_s']:.1f} tok/s, peak "
              f"{run['peak_gb']:.2f} GB allocated, "
              f"{run['peak_reserved_gb']:.2f} reserved (reckoned "
              f"{res['reckoned_peak_gb'][batch]:.2f}; "
              f"{'the run before it dropped, ' if i else ''}no "
              f"clear_caches()); programs: "
              f"{pr['captures']} captures, replays {pr['replays']}, the "
              f"decode graph's {pr['decode_kernel_nodes']:,} kernel nodes × "
              f"{pr['replays']['decode']} replays = "
              f"{pr['decode_nodes_x_replays']:,} launches")
    del out
    if twin:
        label, key, batch, gen, chunk, out = first
        run = res[key]
        fresh()
        torch.cuda.reset_peak_memory_stats()
        g = min(gen, TWIN_GEN)
        with disable_graphs():
            eager = tserve.generate(model, params, out["prompts"], g,
                                    chunk=chunk, log=None)
        run["eager"] = e = _serve_summary(
            eager, batch, g, torch.cuda.max_memory_allocated(),
            cfg.vocab_size)
        check(np.array_equal(out["tokens"][:, :g], eager["tokens"])
              and torch.equal(out["logits0"], eager["logits0"]),
              f"route {route} {label}: the programs' tokens or "
              f"prefill logits differ from the eager twin's")
        print(f"route {route}: {label}: the programs bitwise the eager "
              f"twin (its {TWIN_GEN} tokens, the prefill logits); decode "
              f"{run['decode_ms_per_token']:.2f} ms/token against the "
              f"twin's {e['decode_ms_per_token']:.2f}, prefill "
              f"{run['prefill_ms']:.1f} against {e['prefill_ms']:.1f} "
              f"ms, peak {run['peak_gb']:.2f} against "
              f"{e['peak_gb']:.2f} GB; {card_line()}")
        del eager, out
    del first
    fresh()
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
    depth (24 layers, bf16 compute on fp32 weights drawn on the card from
    a CUDA generator seeded 0) through ``launch/serve.py``:
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
    res, params = serve_route("p", cfg, torch.Generator(
        device="cuda").manual_seed(0), MOE_SERVE_RUNS)
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
    layers, bf16 compute on fp32 weights drawn on the card from a CUDA
    generator seeded 0) through :func:`serve_route`: the
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
    res, params = serve_route("t", cfg, torch.Generator(
        device="cuda").manual_seed(0))
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


@contextlib.contextmanager
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
    try:
        yield
    finally:
        Model.loss = loss


@contextlib.contextmanager
def _recording_state(sink: dict):
    """Each mesh round (``core.mesh.MeshRound``) and each multi-round call
    (``MeshRounds``) run in this process leaves the state it returns in
    ``sink["state"]`` and its context's model index in
    ``sink["model_index"]``; a multi-round call also leaves its ``MeshRounds`` in
    ``sink["rounds"]``."""
    from repro_torch.core import mesh as meshmod
    one, many = meshmod.MeshRound.__call__, meshmod.MeshRounds.__call__

    def rec_one(self, state, batch, seed):
        out = one(self, state, batch, seed)
        sink.update(state=out[0], model_index=self.ctx.model_index())
        return out

    def rec_many(self, state, batches, seeds):
        out = many(self, state, batches, seeds)
        sink.update(state=out[0], model_index=self.rnd.ctx.model_index(),
                    rounds=self)
        return out

    meshmod.MeshRound.__call__ = rec_one
    meshmod.MeshRounds.__call__ = rec_many
    try:
        yield
    finally:
        meshmod.MeshRound.__call__ = one
        meshmod.MeshRounds.__call__ = many


@contextlib.contextmanager
def _cached_params():
    """``models.params.init_params`` (in this process) draws each set of
    params once — per generator seed, device and leaf shapes — and hands
    every later call a copy on the card: the same values, without drawing
    ~745 M values on the host again for each run of a job."""
    from repro_torch.models import params as pdefs
    from repro_torch.models.params import leaves_with_paths, tree_map
    draw, cache = pdefs.init_params, {}

    def cached(defs, generator, device="cpu", ctx=None):
        key = (generator.initial_seed(), str(device), tuple(
            (p, tuple(d.shape)) for p, d in leaves_with_paths(defs)),
            None if ctx is None else (ctx.tp, ctx.model_index()))
        if key not in cache:
            cache[key] = draw(defs, generator, device, ctx=ctx)
        return tree_map(lambda t: t.clone(), cache[key])

    pdefs.init_params = cached
    try:
        yield cache
    finally:
        pdefs.init_params = draw


def _leaf_digests(tree) -> dict:
    """Each leaf's path → the SHA-256 of its bytes."""
    from repro_torch.models.params import leaves_with_paths
    return {"/".join(p): hashlib.sha256(t.detach().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for p, t in leaves_with_paths(tree)}


def _lm_job(job: dict) -> dict:
    """One rank of route o, q, s, u or w: the launch counters at 0, then
    ``launch/train.py``'s ``train`` as a user calls it, without
    ``scan_rounds`` (model at ``job["tp"]``, state, data and rounds, on the
    card; with ``job["keep_params"]`` the gathered params back): each round
    one call of the per-round program (``MeshRounds.round``: on NCCL one
    round captured into a CUDA graph and replayed once a round, on gloo
    its staged body run eagerly), under :func:`graph_spy`. Then the
    counters read; the program's report: whether it captured, the
    programs, captures and replays, the replays' ms, its graph's kernel
    nodes and the capture's launches; every local step's metrics named in
    ``job["metrics"]``, recorded in the loss and read after the call (on a
    captured program the warm-up round's steps, then the capture's, whose
    tensors hold the last replay's values); with ``job["digests"]`` each
    leaf's digest of this rank's final params, m, v and v̂, and its model
    index."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    sink, state = {}, {}
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_recording_metrics(job.get("metrics", ()), sink))
        stack.enter_context(_recording_state(state))
        # a gloo rank's program runs eagerly: nothing to capture or replay
        spy = (stack.enter_context(graph_spy())
               if dist.get_backend() == "nccl"
               else {"captures": 0, "events": []})
        out = ttrain.train(job["cfg"], job["fed"], job["train"],
                           device="cuda", tp=job.get("tp", 1),
                           keep_params=job.get("keep_params", False))
    out["launches"] = dict(ops.launches)
    out["metrics"] = {k: [float(v) for v in vs] for k, vs in sink.items()}
    step = state.pop("rounds")
    prog = step.last["program"]
    out.update(captured=step.last["captured"], programs=len(step.programs),
               captures=spy["captures"],
               replay_ms=[e0.elapsed_time(e1) for e0, e1 in spy["events"]],
               nodes=graph_census(prog.graph)[1] if prog.graph is not None
               else {}, capture_launches=dict(prog.counts or {}))
    st = state.pop("state")
    if job.get("digests"):
        out["model_index"] = state["model_index"]
        out["digests"] = {f: _leaf_digests(getattr(st, f))
                          for f in ("params", "m", "v", "vhat")}
    del st, step, prog
    sink.clear()
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


def o_job() -> dict:
    """Route o's job: gemma2-2b at ``LM_LAYERS`` layers, fedcams over
    ``LM_CLIENTS`` clients, batch 2 × 512 a client, ``LM_ROUNDS``
    rounds."""
    from repro_torch.configs.base import TrainConfig
    return dict(cfg=lm_cfg(), fed=lm_fed(),
                train=TrainConfig(global_batch=2 * LM_CLIENTS, seq_len=512,
                                  rounds=LM_ROUNDS, remat_policy="none"))


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

    job = o_job()
    cfg, fed, train = job["cfg"], job["fed"], job["train"]
    model = Model(cfg)
    leaves = len(tree_leaves(model.defs()))
    d = count_params(model.defs())
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
    rs = [rk["o"] for rk in shared_ranks("gloo2", "o")]
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


#: route o1's chunk: its LM_ROUNDS rounds as one call of the program
O1_SCAN = LM_ROUNDS


def o1_job() -> dict:
    """Route o1's job: route o's configuration at one client on one NCCL
    rank (:func:`_o1_job`)."""
    return dict(_one_rank_job(lm_cfg(), LM_ROUNDS), fn=_o1_job)


def _tree_bytes(tree) -> int:
    """The bytes of a mesh state's (a tuple of trees) or a params tree's
    tensors."""
    from repro_torch.models.params import tree_leaves
    parts = tree if isinstance(tree, tuple) else (tree,)
    return sum(t.numel() * t.element_size() for p in parts
               for t in tree_leaves(p))


def _o1_job(job: dict) -> dict:
    """Route o1 on this NCCL rank, in each of :data:`GRAPH_MODES`:
    ``launch/train.py``'s ``train`` with ``scan_rounds=0`` (the per-round
    loop; each round timed on the host to a synchronize and by CUDA
    events), then ``train`` with ``scan_rounds=O1_SCAN`` (the rounds as one
    program: one round captured into a CUDA graph on the rank's NCCL
    stream and replayed; :func:`_graph_checks`, the spy around the whole
    ``train`` call). Both draw the same init (:func:`_cached_params` hands
    the second a copy of the first's). Under deterministic algorithms the
    program's final state and every round's loss and wire bytes equal the
    loop's to the bit. Returns, by mode, the times, the wrappers' launches,
    the graph's kernel nodes and each run's peak and reserved device
    memory beside what the job holds across runs (the cached init; the
    loop's final state, kept for the check)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    sink, out = {}, {}
    run = lambda **kw: ttrain.train(job["cfg"], job["fed"], job["train"],
                                    device="cuda", log=None, **kw)
    with _cached_params() as cache, _recording_state(sink):
        for mode in GRAPH_MODES:
            with (deterministic() if mode == "deterministic"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                with disable_graphs():      # the eager fed_round loop
                    loop = run()
                loop_ms = (time.perf_counter() - t0) * 1e3
                eager = dict(ops.launches)
                held_loop = held = sum(_tree_bytes(p)
                                       for p in cache.values())
                loop_state = sink.pop("state")
                sink.clear()
                if mode == "deterministic":
                    held += _tree_bytes(loop_state)
                    out["per_round"] = _o1_per_round(run, sink, loop,
                                                     loop_state)
                else:
                    del loop_state
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                with graph_spy() as spy:
                    staged = run(scan_rounds=O1_SCAN)
                call_s = time.perf_counter() - t0
                wrapper = dict(ops.launches)
                scan, st = sink.pop("rounds"), sink.pop("state")
                g = _graph_checks(f"route o1 graph ({mode})", scan, spy,
                                  job["train"].rounds, False)
                reserved = torch.cuda.memory_reserved()
            key = lambda h: [(x["round"], x["loss"], x["wire_up_bytes"])
                             for x in h["history"]]
            if mode == "deterministic":
                bad = _differs(loop_state, st)
                check(not bad and key(loop) == key(staged),
                      f"route o1: the program differs from the loop in {bad};"
                      f" history {key(staged)} vs {key(loop)}")
                del loop_state
            hs = staged["history"]
            out[mode] = dict(
                g, eager_round_ms=[h["round_s"] * 1e3
                                   for h in loop["history"]],
                eager_event_ms=[h["event_ms"] for h in loop["history"]],
                eager_loop_ms=sum(h["round_s"] for h in loop["history"])
                * 1e3, call_ms=sum(h["round_s"] for h in hs) * 1e3,
                train_call_ms=call_s * 1e3, train_loop_ms=loop_ms,
                train_event_ms=[h["event_ms"] for h in hs],
                eager_launches=eager, wrapper_launches=wrapper,
                loss=[h["loss"] for h in hs],
                eager_loss=[h["loss"] for h in loop["history"]],
                wire_up_bytes=[h["wire_up_bytes"] for h in hs],
                finite=loop["finite"] and staged["finite"],
                params=staged["params"], peak_loop=loop["peak_bytes"],
                peak_program=staged["peak_bytes"], reserved=reserved,
                held=held, held_loop=held_loop,
                captured=scan.last["captured"])
            del scan, st, loop, staged
            sink.clear()
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _o1_per_round(run, sink, loop, loop_state) -> dict:
    """Route o1's per-round step: ``train`` without ``scan_rounds``, each
    round one call of ``MeshRounds.round`` (one program at R = 1: one
    capture, a replay a round), under :func:`graph_spy`; its final state
    and every round's loss and wire bytes the eager loop's (``loop``,
    ``loop_state``) to the bit; the graph's kernel nodes its capture's
    launches. Returns the numbers."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    with graph_spy() as spy:
        res = run()
    wrapper = dict(ops.launches)
    step, st = sink.pop("rounds"), sink.pop("state")
    sink.clear()
    rounds = len(res["history"])
    replay = [e0.elapsed_time(e1) for e0, e1 in spy["events"]]
    prog = step.last["program"]
    check(step.last["captured"] and len(step.programs) == 1
          and spy["captures"] == 1 and len(replay) == rounds,
          f"route o1 per-round step: captured {step.last['captured']}, "
          f"{len(step.programs)} programs, {spy['captures']} captures, "
          f"{len(replay)} replays for {rounds} rounds")
    nodes = graph_census(prog.graph)[1]
    check(nodes == {k: prog.counts.get(k, 0) for k in nodes},
          f"route o1 per-round step: the graph's kernel nodes {nodes} "
          f"against the capture's launches {dict(prog.counts)}")
    key = lambda h: [(x["round"], x["loss"], x["wire_up_bytes"])
                     for x in h["history"]]
    bad = _differs(loop_state, st)
    check(not bad and key(loop) == key(res), f"route o1 per-round step: "
          f"differs from the eager loop in {bad}; history {key(res)} vs "
          f"{key(loop)}")
    out = dict(replay_ms=replay,
               call_ms=[h["round_s"] * 1e3 for h in res["history"]],
               nodes=nodes, wrapper_launches=wrapper,
               captures=spy["captures"], programs=len(step.programs),
               peak=res["peak_bytes"], bitwise=True)
    del step, st, res, prog
    gc.collect()
    torch.cuda.empty_cache()
    return out


def route_o1(held) -> dict:
    """Route o1: route o's configuration (gemma2-2b at published widths,
    ``LM_LAYERS`` layers, fedcams with blockwise top-k 1/64 over the
    sparse collective, the fused ingest, K = 2, batch 2 × 512) at one
    client on one NCCL rank, through ``launch/train.py``'s ``train``: the
    per-round loop against ``scan_rounds=O1_SCAN``, one round captured into
    a CUDA graph and replayed (:func:`_o1_job`; :func:`graph_report`: 20
    ``topk_ef_sparse`` and 20 ``fedams_ingest`` nodes in the graph). The
    peak is reckoned first (``lm_memory_reckoning``: the eager round's;
    the graph's private pool holds the round's temporaries on top of the
    carry, the state) and printed beside ``max_memory_allocated``."""
    from repro_torch.core.mesh import mesh_wire_bytes_tiers
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, tree_leaves

    job = o1_job()
    cfg, fed, train = job["cfg"], job["fed"], job["train"]
    model = Model(cfg)
    leaves = len(tree_leaves(model.defs()))
    d = count_params(model.defs())
    plan = lm_memory_reckoning(cfg, d, max(leaf_sizes(cfg)),
                               train.global_batch * train.seq_len)
    pool_gb = plan["per_rank_gb"] - plan["state_gb"]
    free, total = torch.cuda.mem_get_info()
    print(f"route o1: {cfg.name} at published widths, {cfg.num_layers} "
          f"layers, d = {d:,} ({leaves} leaves), one client on one NCCL "
          f"rank; reckoned peak {plan['per_rank_gb']:.2f} GB (the eager "
          f"round), of which the graph's private pool holds the round's "
          f"temporaries, {pool_gb:.2f} GB, beside the carry's "
          f"{plan['state_gb']:.2f} GB state; {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free")
    check(plan["per_rank_gb"] * 1e9 < free,
          f"route o1: one rank does not fit the card: {plan}")
    g = graph_report("o1", shared_ranks("nccl1", "o1")[0]["o1"],
                     {"topk_ef_sparse": leaves, "fedams_ingest": leaves},
                     train.rounds, held)
    tiers = mesh_wire_bytes_tiers(fed, model.defs())
    expected = float(np.float32(fed.num_clients * tiers["tier1"]))
    for mode in GRAPH_MODES:
        r = g[mode]
        check(r["finite"] and r["wire_up_bytes"] == [expected] * train.rounds,
              f"route o1 ({mode}): a non-finite state, or wire_up_bytes "
              f"{r['wire_up_bytes']} against {expected}")
        gb = lambda b: b / 1e9
        print(f"route o1, {mode}: losses {r['loss']} (the loop's "
              f"{r['eager_loss']}); peak memory, the loop "
              f"{gb(r['peak_loop'] - r['held_loop']):.2f} GB, the program "
              f"{gb(r['peak_program'] - r['held']):.2f} GB "
              f"(max_memory_allocated less what the job holds across the "
              f"runs: {gb(r['held_loop']):.2f} and {gb(r['held']):.2f} GB); "
              f"reserved after the program "
              f"{gb(r['reserved']):.2f} GB; reckoned {plan['per_rank_gb']:.2f}"
              f" GB (the graph's pool {pool_gb:.2f}); train's own clock: the "
              f"loop {r['train_loop_ms']:.1f} ms, the program's call "
              f"{r['train_call_ms']:.1f} ms (both with the init and the "
              f"finite checks)")
    g["reckoned"] = dict(plan, graph_pool_gb=pool_gb)
    g["d"], g["leaves"] = d, leaves
    return g


def _job(job: dict) -> dict:
    """``job["fn"]`` on ``job``: one spawn runs jobs of several kinds."""
    return job["fn"](job)


def _one_rank_job(cfg, rounds: int, positive=()) -> dict:
    """:func:`route_one_rank`'s job on ``cfg``: :func:`_lm_job`, one
    client, K = 2, batch 2 × 512, ``rounds`` rounds."""
    from repro_torch.configs.base import TrainConfig
    return dict(fn=_lm_job, cfg=cfg, fed=lm_fed(dp=1),
                train=TrainConfig(global_batch=2, seq_len=512, rounds=rounds,
                                  remat_policy="none"), metrics=positive)


#: the spawns the routes share: group -> (ranks, backend). A group's ranks
#: start once, at its first route, and run every route's jobs in turn (a
#: start and its teardown cost 12-20 s of the script's time)
GROUPS = {"gloo4": (4, "gloo"), "gloo2": (2, "gloo"), "nccl1": (1, "nccl")}
#: each group's results, rank by rank, under "route/job"
_SHARED = {}


def _group_jobs(group: str) -> dict:
    """``group``'s jobs, named "route/job", in the order they run."""
    if group == "gloo4":
        jobs = {f"m/{k}": dict(v, fn=_mesh_job)
                for k, v in mesh_jobs().items()}
        jobs.update({f"w/{k}": dict(v, fn=_lm_job)
                     for k, v in _w_jobs(W_TP).items()})
        jobs["x/moe"] = dict(x_mesh_job(), fn=_x_mesh_job)
    elif group == "gloo2":
        jobs = {"o/o": dict(o_job(), fn=_lm_job)}
        jobs.update({f"w1/{k}": dict(v, fn=_lm_job)
                     for k, v in _w_jobs(1).items()})
        jobs["x/serve"] = dict(x_serve_job(), fn=_x_serve_job)
        jobs["y/y"] = dict(y_job(), fn=_y_job)
    else:
        # each job's programs and graph pools go with it (q's ~54 GB and
        # s's ~61 GB peaks need the card with no other graph memory held)
        jobs = {"m1/m1": dict(m1_job(), fn=_mesh_job),
                "q/q": _one_rank_job(moe_cfg(), MOE_ROUNDS, ("aux",)),
                "s/s": _one_rank_job(mla_train_cfg(), MLA_ROUNDS,
                                     ("aux", "mtp_ce")),
                "u/u": _one_rank_job(rg_train_cfg(), RG_ROUNDS),
                "z/z": dict(fn=_z_job),
                "lm/lm": dict(fn=_lm_example_job),
                "m1/graph": m1_graph_job(),
                "o1/o1": o1_job()}
    return jobs


def shared_ranks(group: str, route: str) -> list:
    """Route ``route``'s results in ``group``'s ranks, rank by rank, each
    keyed by job; the first call starts the group and runs all its jobs."""
    if group not in _SHARED:
        world, backend = GROUPS[group]
        jobs = _group_jobs(group)
        # the ranks share the card with this process: free what its earlier
        # phases cached (the programs' graph pools among it)
        import repro_torch
        repro_torch.clear_caches()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with expandable_segments():
            _SHARED[group] = run_ranks(world, backend, jobs, fn=_job,
                                       timeout=900, record=True)
        took = time.perf_counter() - t0
        jobs_s = sum(r["job_s"] for r in _SHARED[group][0].values())
        print(f"{world} {backend} rank(s) ran {len(jobs)} jobs of routes "
              f"{sorted({k.split('/')[0] for k in jobs})} in {took:.1f} s "
              f"(the jobs {jobs_s:.1f} s on rank 0; start and teardown "
              f"{took - jobs_s:.1f} s); the card's free and rank 0's "
              f"reserved GB after each job "
              f"{ {k: tuple(round(x, 2) for x in r['after_gb']) for k, r in _SHARED[group][0].items()} }")
    pre = route + "/"
    return [{k[len(pre):]: v for k, v in rank.items() if k.startswith(pre)}
            for rank in _SHARED[group]]


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
    from repro_torch.core.mesh import mesh_wire_bytes_tiers
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, tree_leaves

    job = _one_rank_job(cfg, rounds, positive)
    fed, train = job["fed"], job["train"]
    model = Model(cfg)
    leaves = len(tree_leaves(model.defs()))
    d = count_params(model.defs())
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
    r = shared_ranks("nccl1", route)[0][route]
    n_shapes = check_shapes_held(route, [r], held)
    # train's per-round program on the NCCL rank: one round captured, a
    # replay a round; the wrappers launched the warm-up round's kernels,
    # the graph holds a round's, run once a replay
    replays = len(r["replay_ms"])
    check(r["captured"] and r["programs"] == 1 and r["captures"] == 1
          and replays == rounds, f"route {route}: the per-round program "
          f"captured {r['captured']}, {r['programs']} programs, "
          f"{r['captures']} captures, {replays} replays for {rounds} rounds")
    check(r["nodes"] == {k: r["capture_launches"].get(k, 0)
                         for k in r["nodes"]},
          f"route {route}: the graph's kernel nodes {r['nodes']} against "
          f"the capture's launches {r['capture_launches']}")
    want = {"topk_ef_sparse": leaves, "fedams_ingest": leaves}
    got = {k: v for k, v in r["launches"].items() if v}
    nodes = {k: v for k, v in r["nodes"].items() if v}
    check(got == want and nodes == want, f"route {route}: the warm-up's "
          f"launches {got}, the graph's nodes {nodes}, expected {want} "
          f"({leaves} leaves a round)")
    graph = {k: v * replays for k, v in r["nodes"].items()}
    tiers = mesh_wire_bytes_tiers(fed, model.defs())
    expected = float(np.float32(fed.num_clients * tiers["tier1"]))
    losses = [h["loss"] for h in r["history"]]
    check(all(np.isfinite(losses)) and r["finite"],
          f"route {route}: losses {losses} or a non-finite state")
    for name in positive:
        # the warm-up round's steps and the capture's (the last replay's)
        vals = r["metrics"][name]
        check(len(vals) == 2 * fed.local_steps and all(
            np.isfinite(vals)) and min(vals) > 0,
            f"route {route}: the local steps' {name} {vals}")
    wire = [h["wire_up_bytes"] for h in r["history"]]
    check(wire == [expected] * rounds, f"route {route}: wire_up_bytes "
          f"{wire}, mesh_wire_bytes_tiers bills {expected}")
    round_ms = [h["round_s"] * 1e3 for h in r["history"]]
    peak = r["peak_bytes"] / 1e9
    print(f"route {route}: {cfg.name}, {r['params']:,} params, 1 NCCL rank, "
          f"train's per-round program: losses {losses}; local steps' (the "
          f"warm-up's, the last replay's) {r['metrics']}; wire_up_bytes "
          f"{wire[0]:.0f} a round (tiers {tiers}); a round's graph {leaves} "
          f"topk_ef_sparse + {leaves} fedams_ingest nodes; round ms (host, "
          f"the call) {[round(t, 1) for t in round_ms]}, the replays' by "
          f"CUDA events {[round(t, 2) for t in r['replay_ms']]}; peak "
          f"memory {peak:.2f} GB with the graph's pool (reckoned for the "
          f"eager round {plan['per_rank_gb']:.2f}); distinct launch shapes, "
          f"each held by phase 1: {n_shapes}; the job {r['job_s']:.1f} s")
    return {"losses": losses, "metrics": r["metrics"], "wire_up_bytes": wire,
            "tiers": tiers, "round_ms": round_ms,
            "replay_ms": r["replay_ms"], "peak_gb": peak,
            "reckoned": plan, "d": d, "leaves": leaves,
            "shapes_held": n_shapes, "launches": r["launches"],
            "graph_launches": graph}


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


#: route v's runs through launch/serve.py: (batch, prompt, gen, q-chunk).
#: The 4,608-token prompt is two mLSTM q-chunks of 2,304 at chunk 2048,
#: and each sLSTM layer steps 4,608 times; it runs at XLSTM_LONG_LAYERS of
#: the 24 layers (one mLSTM and one sLSTM layer), for the script's time: at
#: all 24 its prefill took 22.1 s of host-bound sLSTM steps; at 4 its first
#: call through the programs (two warm-ups, the captures, a replay) 9.7 s
#: (H100 80GB HBM3, 700.00 W)
XLSTM_SERVE_RUNS = ((4, 512, 32, 2048),)
XLSTM_LONG_RUN, XLSTM_LONG_LAYERS = (1, 4608, 16, 2048), 2
#: route v's decode against the forward: xlstm-350m's widths at 4 layers,
#: fp32, a prompt of 96 and 8 decode steps
XLSTM_DECODE_LAYERS = 4


def route_v() -> dict:
    """Route v: xlstm-350m served at its published widths and depth (24
    layers alternating mLSTM and sLSTM, d_model 1024, 4 heads, the mLSTM 2048
    wide, vocabulary 50,304; 343,856,128 params, bf16 compute on fp32
    weights drawn on the card) through :func:`serve_route`: batch 4 × 512 +
    32; then 1 × 4,608 + 16 (two mLSTM q-chunks of 2,304; the sLSTM state
    carried over 4,608 sequential steps) at ``XLSTM_LONG_LAYERS`` layers,
    on weights drawn for them. Then decode against the
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
    res["long"], params = serve_route(
        "v", mreplace(cfg, num_layers=XLSTM_LONG_LAYERS), torch.Generator(
            device="cuda").manual_seed(3), runs=(XLSTM_LONG_RUN,),
        twin=False)
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
#: its largest |value|, at one local step and at route w's own K = 2. At
#: all 24 layers the round is ill-conditioned at K = 2 in the reference as
#: in the port (ROADMAP Queue 3 item 29: the zero-initialised sLSTM bias,
#: all update, read 0.50 tp 2 against tp 1 there); at these 2 layers tp 2
#: against tp 1 read 6.79e-6 / 6.64e-6 at K = 1 / 2 and the same tp 1 round
#: on the host's CPU against the card 7.58e-6 (H100 80GB HBM3, 700.00 W).
#: That CPU witness is no longer run (15 s of the script's time): at 2
#: layers its bound, ten times its reading, never rose above W_PARAMS_TOL
W_LOSS_RTOL, W_PARAMS_TOL = 1e-4, 1e-3
#: the pairs' depth and sequence: 2 of the 24 layers (one mLSTM and one
#: sLSTM) and 128 tokens (the main run's 512 / 4)
W_PAIR_LAYERS, W_PAIR_SEQ = 2, 128


def _w_jobs(tp: int):
    """Route w's jobs at ``tp``: at W_TP the main run (fedcams, blockwise
    top-k 1/64 over the sparse collective, fused ingest, K = 2, batch 2 ×
    512 a client, η ``W_ETA``, η_l ``W_ETA_L``, W_ROUNDS rounds), then the
    FedAvg rounds at one and at two local steps (the same η_l, sequences
    of ``W_PAIR_SEQ``), each keeping its ranks' digests; at 1 the two
    FedAvg rounds."""
    from repro_torch.configs.base import TrainConfig, mreplace
    cfg = w_cfg()
    train = TrainConfig(global_batch=2 * W_DP, seq_len=512, rounds=W_ROUNDS,
                        remat_policy="none")
    avg = dataclasses.replace(w_fed(), algorithm="fedavg",
                              compressor="none", aggregation="dense")
    pair = dict(cfg=mreplace(cfg, dtype="float32", num_layers=W_PAIR_LAYERS),
                train=dataclasses.replace(train, rounds=1,
                                          seq_len=W_PAIR_SEQ),
                tp=tp, keep_params=True, digests=tp > 1)
    jobs = {f"avg{k}": dict(pair, fed=dataclasses.replace(avg, local_steps=k))
            for k in (1, 2)}
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
    """Route w: xlstm-350m at its published widths and ``W_LAYERS`` layers
    trained through ``launch/train.py``'s ``train`` on dp ``W_DP`` × tp ``W_TP``:
    four gloo ranks sharing the card, each holding its model shards.
    fedcams with blockwise top-k 1/64 over the sparse collective and the
    fused ingest, K = 2, batch 2 × 512 a client, η ``W_ETA``, η_l
    ``W_ETA_L``, ``W_ROUNDS`` rounds: each rank launches ``topk_ef_sparse``
    and ``fedams_ingest`` once a model-local leaf a round, at shapes phase
    1 held; ``wire_up_bytes`` as ``mesh_wire_bytes_tiers`` bills the local
    leaves × tp; losses and state finite; every replicated leaf of the
    final state the same on all four ranks. Then dense FedAvg rounds in
    fp32 at one and at two local steps on the same ranks and on dp 2 × tp
    1 (two ranks), from the same seeded init, held as the constants above
    say."""
    from repro_torch.core.mesh import mesh_wire_bytes_tiers
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, local_shape, \
        tree_leaves, tree_map

    cfg, fed = w_cfg(), w_fed()
    model = Model(cfg, tp=W_TP)
    local = tree_map(lambda d: dataclasses.replace(
        d, shape=local_shape(d, {"model": W_TP})), model.defs())
    leaves = len(tree_leaves(local))
    d_all, d = count_params(model.defs()), count_params(local)
    plan = lm_memory_reckoning(cfg, d, max(leaf_sizes(cfg, W_TP)), 512)
    world = W_DP * W_TP
    free, total = torch.cuda.mem_get_info()
    print(f"route w: {cfg.name}, {cfg.num_layers} layers, {d_all:,} params "
          f"in {leaves} leaves; a "
          f"rank at tp {W_TP} holds {d:,} (its model shards); reckoned "
          f"~{plan['per_rank_gb']:.1f} GB a rank at its peak ({plan}); "
          f"{world} ranks on a card with {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free")
    check(world * plan["per_rank_gb"] * 1e9 < free,
          f"route w: {world} ranks do not fit the card: {plan}")
    ranks = shared_ranks("gloo4", "w")
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

    one = shared_ranks("gloo2", "w1")[0]
    pairs = {}
    for k in ("avg1", "avg2"):
        a2, a1 = ranks[0][k], one[k]
        loss2, loss1 = a2["history"][0]["loss"], a1["history"][0]["loss"]
        pairs[k] = {"loss": [loss2, loss1],
                    "loss_rel_err": abs(loss2 - loss1) / abs(loss1),
                    "errs": _leaf_errs(a2["params"], a1["params"])}
    for k, steps in (("avg1", "one"), ("avg2", "two")):
        err = pairs[k]
        check(err["loss_rel_err"] <= W_LOSS_RTOL
              and max(err["errs"].values()) <= W_PARAMS_TOL,
              f"route w: the FedAvg round at {steps} local step(s), dp "
              f"{W_DP} x tp {W_TP} vs dp {W_DP} x tp 1: loss {err['loss']} "
              f"({err['loss_rel_err']:.3g}), the worst leaves "
              f"{_worst(err['errs'])}")
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
    jobs_s = {f"tp{tp} {k}": round(r["job_s"], 1)
              for tp, rk in ((W_TP, ranks[0]), (1, one)) for k, r in rk.items()}
    print(f"route w: the pairs at {W_PAIR_LAYERS} layers, {W_PAIR_SEQ} "
          f"tokens; the jobs' seconds on rank 0 {jobs_s}")
    return {"losses": losses, "wire_up_bytes": wire, "tiers": tiers,
            "round_ms": round_ms, "peak_gb": peaks, "reckoned": plan,
            "d": d_all, "d_rank": d, "leaves": leaves, "shapes_held": n_shapes,
            "replicated_leaves": n_rep,
            "fedavg_tp2_vs_tp1": pairs,
            "part_seconds": jobs_s,
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
    base = torch.cuda.memory_allocated()   # the rank's earlier jobs' own
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
        res["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        out[name] = res
        gc.collect()
    out["launches"] = dict(ops.launches)
    return out


def _x_mesh_job(job: dict) -> dict:
    """One of route x's four ranks: (1) the MoE cut at tp ``X_MOE_TP``
    (weights drawn on the card, this rank's shards kept): prefill + decode
    against the forward, every dispatch's top-k recorded (no pad expert
    chosen, the pad experts' router probs 0); (2) the sequence-sharded
    decode over ``X_SEQ_SHARDS`` ranks of "data" in the context
    ``launch/steps.py``'s ``serve_ctx`` makes (the "rep" dim's ranks
    repeat it) against the unsharded decode."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import steps
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

    # the serving context of launch/steps.py over ("data", "model") with a
    # model dim of 1; the "rep" dim's ranks repeat the work
    mesh = make_mesh((X_MOE_TP // X_SEQ_SHARDS, X_SEQ_SHARDS, 1),
                     ("rep", "data", "model"), "cuda")
    seq = steps.serve_ctx(mesh, seq_sharded=True)
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


def x_serve_job() -> dict:
    """Route x's serving job at tp ``X_TP``: gemma2-2b at full width and
    depth (route n's weights), and in fp32 at 2 and at 26 layers."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("gemma2-2b").model
    small = mreplace(cfg, num_layers=2, dtype="float32")
    deep = mreplace(cfg, dtype="float32")
    return {"runs": {"full": (cfg, 4, 512, 32, 0),
                     "fp32": (small, 2, 96, 2, 1),
                     "fp32_full": (deep, 2, 96, 2, 3)}}


def x_mesh_job() -> dict:
    """Route x's job on four ranks: the MoE cut at tp ``X_MOE_TP``, and
    gemma2-2b's widths at 2 layers for the sequence-sharded decode."""
    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    base = get_arch("qwen2-moe-a2.7b").model
    moe_cfg = mreplace(base, num_layers=X_MOE_LAYERS, dtype="float32",
                       moe=dataclasses.replace(
                           base.moe, num_experts=X_MOE_EXPERTS,
                           capacity_factor=X_MOE_CF))
    return {"moe_cfg": moe_cfg, "seq_cfg": x_serve_job()["runs"]["fp32"][0]}


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
    rk = [{"x": r["serve"]} for r in shared_ranks("gloo2", "x")]
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

    moe_cfg = x_mesh_job()["moe_cfg"]
    r4 = [{"x": r["moe"]} for r in shared_ranks("gloo4", "x")]
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


# ---------------------------------------------------------------------------
# route y: launch/steps.py's decode entry at long_500k, the step rooflines
# and the dry run on the card's host
# ---------------------------------------------------------------------------

#: route y: gemma2-2b decoded at long_500k (batch 1, 524,288 slots) through
#: ``steps.build_decode_step``, the cache's slots split over the ``Y_SHARDS``
#: gloo ranks of a (2, 1) ("data", "model") mesh sharing the card:
#: ``Y_STEPS`` tokens from position ``Y_POS0`` (the last slots, rank 1's
#: block); held to the unsharded decode at ``Y_SMALL_LAYERS`` layers in fp32
#: within route x's tolerance
Y_SHARDS, Y_STEPS, Y_POS0, Y_SMALL_LAYERS = 2, 8, 524280, 2
Y_TOL = X_SEQ_TOL
#: route n's decode shape for the step roofline: batch 4, 544 slots
Y_N_BATCH, Y_N_LEN = 4, 544


def _y_spec(cfg=None):
    """gemma2-2b's ``ArchSpec`` with ``cfg`` as its model (None: the
    published one)."""
    from repro_torch.configs.registry import get_arch
    spec = get_arch("gemma2-2b")
    return spec if cfg is None else dataclasses.replace(spec, model=cfg)


def _y_cfg(layers: int = 0, dtype: str = ""):
    """gemma2-2b's model cut to ``layers`` in ``dtype`` (0 / "": the
    published depth and dtype)."""
    from repro_torch.configs.base import mreplace
    kw = dict(({"num_layers": layers} if layers else {}),
              **({"dtype": dtype} if dtype else {}))
    return mreplace(_y_spec().model, **kw)


def _y_weights(model, dtype: str, seed: int, device):
    """The model's weights in ``dtype``, drawn where ``device`` is from a
    generator seeded ``seed`` (every rank draws the same: tp 1)."""
    from repro_torch.models import params as pdefs
    defs = pdefs.tree_map(lambda d: dataclasses.replace(d, dtype=dtype),
                          model.defs())
    return pdefs.init_params(
        defs, torch.Generator(device=device).manual_seed(seed), device)


def _y_cache(model, batch: int, max_len: int, ctx, seed: int, device,
             seq_sharded: bool):
    """A decode cache drawn as the global one (a generator seeded ``seed``,
    one layer of the stack at a time), this rank keeping its block
    (``take_shard``): every layout of the mesh holds the same global
    cache."""
    from repro_torch.models import params as pdefs
    cdefs = model.cache_defs(batch, max_len, seq_sharded=seq_sharded)
    caches = model.init_cache(batch, max_len, seq_sharded=seq_sharded,
                              device=device, ctx=ctx)
    g = torch.Generator(device=device).manual_seed(seed)
    for (path, d), t in zip(pdefs.leaves_with_paths(cdefs),
                            pdefs.tree_leaves(caches)):
        check(path[0] == "groups", f"route y: an unstacked cache leaf {path}")
        layer = pdefs.ParamDef(d.shape[1:], dtype=d.dtype,
                               spec=d.dim_specs[1:])
        for i in range(d.shape[0]):
            full = torch.randn(layer.shape, generator=g, dtype=t.dtype,
                               device=device)
            t[i].copy_(pdefs.take_shard(full, layer, ctx))
            del full
    return caches


def _y_decode(fn, params, make_caches, toks, pos0: int, steps: int):
    """``steps`` calls of the decode step ``fn`` from ``pos0`` on the
    caches ``make_caches()`` draws (made here, so that no caller holds
    the first ones while the steps make new ones): the logits (host,
    fp32), each call's host ms (the card synchronized before and after)
    and the last caches."""
    caches = make_caches()
    out, ms = [], []
    with torch.no_grad():
        for i in range(steps):
            _sync()
            t0 = time.perf_counter()
            lg, caches = fn(params, toks[:, i:i + 1], caches, pos0 + i)
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(lg.float().cpu())
    return torch.stack(out), ms, caches


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _on_meta(args):
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, args)


def _counts(c) -> list:
    """What the card's count and the meta count are held equal on."""
    return [c.ops, c.flops, c.bytes, c.rw_bytes,
            sorted((k, int(v)) for k, v in c.coll_bytes.items())]


def _y_step_cost(fn, args) -> dict:
    """``launch/op_analysis``'s counts of one call of ``fn`` on ``args``
    (real tensors on the card) and on meta copies of them; the meta
    count's memory record."""
    from repro_torch.launch import op_analysis as oa
    with torch.no_grad():
        card = oa.measure(fn, *args)
        meta = oa.analyze(fn, *_on_meta(args))
    return {"card": _counts(card), "meta": _counts(meta),
            "memory": meta.memory, "cost": meta}


def _roofline(cost, chips: int, cfg, kind: str, tokens: int,
              local_steps: int = 1) -> dict:
    from repro_torch.launch.mesh import backend_spec
    from repro_torch.launch.roofline import model_flops_for, roofline_from_cost
    spec = backend_spec()
    rl = roofline_from_cost(cost, chips=chips, spec=spec,
                            model_flops=model_flops_for(cfg, kind, tokens,
                                                        local_steps))
    return dict(rl.to_dict(), backend=spec.name)


def _y_job(job: dict) -> dict:
    """One of route y's ranks, in turn: (1) gemma2-2b at full depth, bf16
    weights, decoded at long_500k through ``steps.build_decode_step`` on a
    (2, 1) ("data", "model") mesh: the dry run's count of the step on meta
    (its reckoned memory), the cache drawn as the global one and cut to
    this rank's slots, ``Y_STEPS`` timed steps, then one more counted by
    ``launch/op_analysis`` on the card and on meta; (2) the same at
    ``Y_SMALL_LAYERS`` layers in fp32; (3) route o's train round built with
    ``steps.build_train_step`` and ``KernelImpl``: 3 rounds timed (the
    first a warm-up) and the round counted on meta. Returns rank 0's
    logits and every rank's times, counts and peaks."""
    import torch.distributed as dist

    from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig, TrainConfig
    from repro_torch.core.mesh import init_fed_state, shard_batch
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    dev = job.get("device", "cuda")
    # the peaks are read above what the rank's earlier jobs left allocated
    base = torch.cuda.memory_allocated() if dev != "cpu" else 0
    mesh = make_mesh((Y_SHARDS, 1), ("data", "model"), dev)
    shape = job.get("shape", INPUT_SHAPES["long_500k"])
    pos0 = shape.seq_len - Y_STEPS
    out = {}
    for name, (cfg, wdtype) in job["decodes"].items():
        spec = _y_spec(cfg)
        b = steps.build_decode_step(spec, shape, mesh)
        check(b.ctx.seq_shards == Y_SHARDS and "seq-sharded" in
              b.description, f"route y: {b.description}, "
              f"{b.ctx.seq_shards} shards")
        params = _y_weights(b.model, wdtype, 1, dev)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, spec.model.vocab_size, size=(1, Y_STEPS + 1)).astype(
                np.int32)).to(dev)
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        logits, ms, caches = _y_decode(
            b.fn, params, lambda: _y_cache(b.model, 1, shape.seq_len, b.ctx,
                                           2, dev, True), toks, pos0, Y_STEPS)
        peak = (torch.cuda.max_memory_allocated() - base if dev != "cpu"
                else 0)
        # one more step counted on the card and on meta (the same inputs)
        counts = _y_step_cost(b.fn, (params, toks[:, -1:], caches,
                                     shape.seq_len - 1))
        out[name] = {"logits": logits if dist.get_rank() == 0 else None,
                     "ms": ms, "peak_bytes": peak,
                     "reckoned": counts["memory"],
                     "counts": counts, "slots": b.abstract_args[2]
                     ["groups"]["l1"]["k"].shape[2]}
        del params, caches, b
        gc.collect()
        if dev != "cpu":
            torch.cuda.empty_cache()

    # route o's train round through steps.build_train_step
    spec = _y_spec(job["train_cfg"])
    fed, tcfg = job["fed"], TrainConfig(remat_policy="none")
    shape = ShapeConfig("route_o", 512, 2 * Y_SHARDS, "train")
    b = steps.build_train_step(spec, shape, mesh, fed, tcfg,
                               kernel_impl=ops.KernelImpl(device=dev))
    tcfg = dataclasses.replace(tcfg, global_batch=shape.global_batch,
                               seq_len=shape.seq_len)
    meta = oa.analyze(b.fn, *b.abstract_args)
    state = init_fed_state(b.model, b.fed, torch.Generator(
        device=dev).manual_seed(0), b.ctx, dev)
    data = FederatedLMData(num_clients=b.fed.num_clients,
                           vocab_size=spec.model.vocab_size, seed=0)
    ops.reset_launches()
    round_ms, losses = [], []
    for r in range(3):
        batch = shard_batch(data.mesh_batch(r, b.fed.local_steps,
                                            shape.global_batch,
                                            shape.seq_len),
                            b.model, b.fed, tcfg, b.ctx, "cuda")
        dist.barrier()
        _sync()
        t0 = time.perf_counter()
        state, met = b.fn(state, batch, r)
        _sync()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    out["train"] = {"round_ms": round_ms, "losses": losses,
                    "launches": dict(ops.launches), "cost": meta,
                    "description": b.description}
    return out


def _y_unsharded(cfg, wdtype: str, shape, device="cuda"):
    """The decode of one of :func:`_y_job`'s runs in this process, its
    cache whole (``ParallelContext()``), the weights, cache and tokens
    drawn as the ranks draw them; returns the logits and the step
    times."""
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import ParallelContext
    model = Model(cfg)
    ctx = ParallelContext()
    params = _y_weights(model, wdtype, 1, device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, Y_STEPS + 1)).astype(
            np.int32)).to(device)

    def fn(p, t, c, pos):
        return model.decode_step(p, t, c, pos, ctx, max_len=shape.seq_len)

    logits, ms, _ = _y_decode(
        fn, params, lambda: _y_cache(model, 1, shape.seq_len, ctx, 2, device,
                                     False), toks, shape.seq_len - Y_STEPS,
        Y_STEPS)
    return logits, ms


def _y_route_n_step(cfg, device="cuda") -> dict:
    """Route n's decode shape (gemma2-2b, fp32 weights, bf16 compute,
    batch ``Y_N_BATCH``, ``Y_N_LEN`` slots, tp 1) built with
    ``steps.build_decode_step`` on a (1, 1) mesh of a one-rank gloo group:
    a warm-up step, ``Y_STEPS`` timed, one counted on the card and on
    meta."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        spec = _y_spec(cfg)
        shape = ShapeConfig("decode_n", Y_N_LEN, Y_N_BATCH, "decode")
        b = steps.build_decode_step(spec, shape,
                                    make_mesh((1, 1), ("data", "model"),
                                              device))
        params = b.model.init(torch.Generator(device=device).manual_seed(0),
                              device)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, spec.model.vocab_size, size=(Y_N_BATCH, Y_STEPS + 2)).astype(
                np.int32)).to(device)
        _, ms, caches = _y_decode(
            b.fn, params, lambda: _y_cache(b.model, Y_N_BATCH, Y_N_LEN, b.ctx,
                                           4, device, False), toks,
            Y_N_LEN - Y_STEPS - 2, Y_STEPS + 1)
        counts = _y_step_cost(b.fn, (params, toks[:, -1:], caches,
                                     Y_N_LEN - 1))
        del params, caches
        return {"ms": ms[1:], "counts": counts, "model": b.model}
    finally:
        dist.destroy_process_group()


def _y_dryrun(out_path: str) -> tuple:
    """``python -m repro_torch.launch.dryrun`` on one case (gemma2-2b,
    long_500k, the 16 × 16 mesh) in a subprocess; (stdout, the case)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "long_500k", "--mesh", "single", "--out",
         out_path, "--overwrite"], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    check(res.returncode == 0, f"route y: the dry run exited "
          f"{res.returncode}: {res.stderr[-2000:]}")
    check("[ok] baseline/pod16x16/gemma2-2b/long_500k" in res.stdout,
          f"route y: the dry run printed no [ok]: {res.stdout[-2000:]}")
    case = json.loads(Path(out_path).read_text())[
        "baseline/pod16x16/gemma2-2b/long_500k"]
    return res.stdout.strip(), case, time.perf_counter() - t0


def _rl_line(rl: dict, measured_ms: float) -> str:
    share = max(rl["compute_s"], rl["memory_s"]) / (measured_ms / 1e3)
    return (f"compute {rl['compute_s'] * 1e3:.4f} ms, memory "
            f"{rl['memory_s'] * 1e3:.4f} ms, collective "
            f"{rl['collective_s'] * 1e3:.4f} ms, dominant {rl['dominant']} "
            f"(against {rl['backend']}); measured {measured_ms:.2f} ms: "
            f"max(compute, memory) / measured = {share:.4f}")


def y_job() -> dict:
    """Route y's job on ``Y_SHARDS`` ranks: gemma2-2b's decodes at long_500k
    (bf16 at full depth, fp32 at ``Y_SMALL_LAYERS``) and route o's
    round."""
    return {"decodes": {"full": (_y_cfg(), "bfloat16"),
                        "fp32": (_y_cfg(Y_SMALL_LAYERS, "float32"),
                                 "float32")},
            "train_cfg": lm_cfg(), "fed": lm_fed()}


def route_y() -> dict:
    """Route y: ``launch/steps.py``'s decode entry at long_500k on the card,
    the step rooflines and the dry run. (a) gemma2-2b at full width and
    depth (bf16 weights drawn on the card, bf16 compute) decoded through
    ``steps.build_decode_step`` at long_500k (batch 1, 524,288 slots) on
    ``Y_SHARDS`` gloo ranks sharing the card, each holding half the
    slots: ms a token and peak memory a rank beside the dry run's reckoned
    peak; the same steps unsharded in this process (the largest logit
    difference, unbounded at bf16); at ``Y_SMALL_LAYERS`` layers in fp32
    within ``Y_TOL``. (b) ``launch/op_analysis``'s count of route y's step
    and of route n's decode shape on the card equals its count on meta:
    ops, FLOPs, bytes, collective bytes by kind. (c) The roofline of
    those two steps and of route o's train round (``steps.
    build_train_step`` with ``KernelImpl``) against ``h100_sxm`` beside
    the measured step. (d) The dry run of gemma2-2b at long_500k on the
    16 × 16 mesh prints ``[ok]``."""
    from repro_torch.configs.base import INPUT_SHAPES

    card = card_line()
    shape = INPUT_SHAPES["long_500k"]
    free, total = torch.cuda.mem_get_info()
    decodes = y_job()["decodes"]
    t0 = time.perf_counter()
    rk = shared_ranks("gloo2", "y")
    seconds = {"ranks": time.perf_counter() - t0, "ranks_job": rk[0]["y"][
        "job_s"]}
    ys = [r["y"] for r in rk]
    full, small, tr = ys[0]["full"], ys[0]["fp32"], ys[0]["train"]
    cfg = _y_cfg()
    # (a) the sharded steps, then the same unsharded here
    for y in ys:
        for name in ("full", "fp32"):
            check(y[name]["counts"]["card"] == y[name]["counts"]["meta"],
                  f"route y: {name}: the card's count "
                  f"{y[name]['counts']['card']} != meta's "
                  f"{y[name]['counts']['meta']}")
    check(full["slots"] == shape.seq_len // Y_SHARDS,
          f"route y: {full['slots']} slots a rank")
    check(bool(torch.isfinite(full["logits"]).all()),
          "route y: non-finite logits")
    t0 = time.perf_counter()
    ref_full, ms_ref = _y_unsharded(*decodes["full"], shape)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["unsharded_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_small, _ = _y_unsharded(*decodes["fp32"], shape)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["unsharded_fp32"] = time.perf_counter() - t0
    full_err = _rel_err(full["logits"], ref_full)
    small_err = _rel_err(small["logits"], ref_small)
    check(small_err <= Y_TOL, f"route y: fp32, {Y_SMALL_LAYERS} layers: "
          f"sequence-sharded vs unsharded {small_err} (tolerance {Y_TOL})")
    tok_ms = float(np.median([m for y in ys for m in y["full"]["ms"][1:]]))
    peaks = [y["full"]["peak_bytes"] / 1e9 for y in ys]
    reck = full["reckoned"]
    reck_gb = (reck["argument_size"] + reck["temp_size"]) / 1e9
    for i, peak in enumerate(peaks):
        check(abs(peak - reck_gb) <= RECKON_TOL * reck_gb,
              f"route y rank {i}: peak {peak:.4f} GB against the reckoned "
              f"{reck_gb:.4f} GB: more than {RECKON_TOL:.0%} apart")
    print(f"route y [{card}]: gemma2-2b, {cfg.num_layers} layers, bf16, "
          f"long_500k through steps.build_decode_step on {Y_SHARDS} gloo "
          f"ranks ({full['slots']:,} slots a rank): {Y_STEPS} tokens from "
          f"position {Y_POS0:,}: {tok_ms:.2f} ms a token (median of steps "
          f"2-{Y_STEPS}, both ranks; first step {full['ms'][0]:.2f} ms); "
          f"peak a rank {[round(p, 4) for p in peaks]} GB, the dry run's "
          f"reckoned peak {reck_gb:.4f} GB, within {RECKON_TOL:.0%} "
          f"(arguments "
          f"{reck['argument_size'] / 1e9:.2f} + temporaries "
          f"{reck['temp_size'] / 1e9:.2f}); unsharded in one process "
          f"{np.median(ms_ref[1:]):.2f} ms a token, logits vs sharded "
          f"{full_err:.3g} of the largest (bf16, no bound); at "
          f"{Y_SMALL_LAYERS} layers fp32 {small_err:.3g} (tolerance "
          f"{Y_TOL}); {free / 1e9:.1f} of {total / 1e9:.1f} GB free before")
    # (b) + (c): route n's decode shape, then the three rooflines
    t0 = time.perf_counter()
    n_step = _y_route_n_step(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["route_n_step"] = time.perf_counter() - t0
    check(n_step["counts"]["card"] == n_step["counts"]["meta"],
          f"route y: route n's decode shape: the card's count "
          f"{n_step['counts']['card']} != meta's {n_step['counts']['meta']}")
    n_ms = float(np.median(n_step["ms"]))
    rl = {"y_decode": _roofline(full["counts"]["cost"], Y_SHARDS, cfg,
                                "decode", 1),
          "n_decode": _roofline(n_step["counts"]["cost"], 1, cfg, "decode",
                                Y_N_BATCH),
          "o_train": _roofline(tr["cost"], Y_SHARDS, lm_cfg(), "train",
                               2 * Y_SHARDS * 512, lm_fed().local_steps)}
    train_ms = float(np.median(tr["round_ms"][1:]))
    check(all(np.isfinite(y["train"]["losses"]).all() for y in ys),
          f"route y: train losses {tr['losses']}")
    counts = {k: [y[k]["counts"]["card"] for y in ys] for k in ("full",
                                                               "fp32")}
    print(f"route y [{card}]: op_analysis on the card = on meta (ops, "
          f"FLOPs, bytes, rw bytes, collective bytes): y's step a rank "
          f"{counts['full']}, route n's decode shape "
          f"{n_step['counts']['card']}")
    print(f"route y [{card}]: step roofline, y's decode (a rank; the two "
          f"ranks share one card): {_rl_line(rl['y_decode'], tok_ms)}")
    print(f"route y [{card}]: step roofline, route n's decode shape "
          f"(batch {Y_N_BATCH}, {Y_N_LEN} slots, fp32 weights): "
          f"{_rl_line(rl['n_decode'], n_ms)}")
    print(f"route y [{card}]: step roofline, route o's train round "
          f"({tr['description']}, rank 0 of {Y_SHARDS} sharing the card; "
          f"rounds {[round(t, 1) for t in tr['round_ms']]} ms, launches "
          f"{ {k: v for k, v in tr['launches'].items() if v} }): "
          f"{_rl_line(rl['o_train'], train_ms)}")
    # (d) the dry run on this host
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    dry_out, dry, dry_s = _y_dryrun(str(outdir / "dryrun_torch.json"))
    seconds["dryrun"] = dry_s
    print(f"route y [{card}]: dry run ({dry_s:.1f} s): {dry_out}")
    print(f"route y: seconds by part "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    for v in rl.values():
        v.pop("backend")
    return {"card": card, "ms_a_token": tok_ms, "first_ms": full["ms"][0],
            "peak_gb": peaks, "reckoned_gb": reck_gb, "reckoned": reck,
            "unsharded_ms_a_token": float(np.median(ms_ref[1:])),
            "bf16_vs_unsharded_rel_err": full_err,
            "fp32_vs_unsharded_rel_err": small_err,
            "counts": counts, "n_counts": n_step["counts"]["card"],
            "n_ms_a_token": n_ms, "train_round_ms": tr["round_ms"],
            "train_losses": tr["losses"], "rooflines": rl,
            "part_seconds": seconds,
            "dryrun": {k: dry[k] for k in ("status", "trace_s", "memory",
                                           "roofline")},
            "launches": {k: sum(y["train"]["launches"][k] for y in ys)
                         for k in tr["launches"]}}


@contextlib.contextmanager
def program_parts():
    """Times a mesh program's first call (``core.mesh._RoundsProgram``) by
    part: its warm-up round (``step(write=False)``) by CUDA events on its
    stream and on the host's clock to a synchronize, its capture
    (``CUDAGraph.capture_begin`` to ``capture_end``) and its instantiation
    on the host's clock. Yields the record: lists of ms and s."""
    from repro_torch.core import mesh as meshmod
    G, P = torch.cuda.CUDAGraph, meshmod._RoundsProgram
    step, begin, end, inst = P.step, G.capture_begin, G.capture_end, \
        G.instantiate
    rec = {"warmup_event_ms": [], "warmup_s": [], "capture_s": [],
           "instantiate_s": []}
    at = {}

    def timed_step(self, write=True):
        if write:
            return step(self, write)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = step(self, write)
        e1.record()
        torch.cuda.synchronize()
        rec["warmup_s"].append(time.perf_counter() - t0)
        rec["warmup_event_ms"].append(e0.elapsed_time(e1))
        return out

    def timed_begin(self, *a, **kw):
        at["capture"] = time.perf_counter()
        return begin(self, *a, **kw)

    def timed_end(self, *a, **kw):
        out = end(self, *a, **kw)
        rec["capture_s"].append(time.perf_counter() - at.pop("capture"))
        return out

    def timed_inst(self, *a, **kw):
        t0 = time.perf_counter()
        out = inst(self, *a, **kw)
        rec["instantiate_s"].append(time.perf_counter() - t0)
        return out

    P.step, G.capture_begin, G.capture_end, G.instantiate = (
        timed_step, timed_begin, timed_end, timed_inst)
    try:
        yield rec
    finally:
        P.step, G.capture_begin, G.capture_end, G.instantiate = (
            step, begin, end, inst)


@contextlib.contextmanager
def nondeterminism_noted(sink: list):
    """Deterministic algorithms, warn-only: each op that has no
    deterministic implementation on the card runs and is noted in
    ``sink`` (a pair held to the bit fails if one ran)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        sink.extend(sorted({str(w.message)[:160] for w in caught
                            if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(False)


def _same_metrics(a: dict, b: dict) -> bool:
    """Two rounds' metrics (0-d tensors, on the host or the card) equal to
    the bit."""
    bits = lambda t: t.detach().to("cpu", torch.float32).reshape(1).view(
        torch.int32)
    return sorted(a) == sorted(b) and all(torch.equal(bits(a[k]), bits(b[k]))
                                          for k in a)


def _z_bundle(seq: int):
    """Route z's step (``steps.build_train_step`` with the dry run's
    settings at ``Z_LOCAL_STEPS``) at batch ``Z_BATCH`` x ``seq`` on a
    (1, 1) ("data", "model") mesh, its TrainConfig at that shape, the
    init drawn on the card from seed 0 and round r's batch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.mesh import init_fed_state, shard_batch
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    fed, train = z_configs()
    spec = dataclasses.replace(get_arch("xlstm-350m"), model=z_cfg())
    b = steps.build_train_step(spec, ShapeConfig(
        "train_4k, one client", seq, Z_BATCH, "train"),
        make_mesh((1, 1), ("data", "model"), "cuda"), fed, train)
    tcfg = dataclasses.replace(train, global_batch=Z_BATCH, seq_len=seq)
    data = FederatedLMData(num_clients=b.fed.num_clients,
                           vocab_size=spec.model.vocab_size, seed=0)
    init = lambda: init_fed_state(b.model, b.fed, torch.Generator(
        device="cuda").manual_seed(0), b.ctx, "cuda")
    batch = lambda r: shard_batch(data.mesh_batch(
        r, b.fed.local_steps, Z_BATCH, seq), b.model, b.fed, tcfg, b.ctx,
        "cuda")
    return b, init, batch


def _z_pair() -> dict:
    """Route z's round at batch ``Z_BATCH`` x ``Z_CHECK_SEQ`` under
    deterministic algorithms: ``b.fn`` (the program: a warm-up round, the
    capture, a replay) and its eager twin under ``disable_graphs()``, from
    the same init: which state fields differ in any bit, whether the
    metrics are the same bits, the program's report and each call's
    seconds. Then ``repro_torch.clear_caches()``."""
    import repro_torch
    from repro_torch.core.mesh import _map
    b, init, batch = _z_bundle(Z_CHECK_SEQ)
    st0, x = init(), batch(0)
    # the program consumes the state it is given: the twin starts from a copy
    twin0 = _map(torch.clone, st0)
    notes = []
    with nondeterminism_noted(notes):
        _sync()
        t0 = time.perf_counter()
        st, met = b.fn(st0, x, 0)
        _sync()
        prog_s = time.perf_counter() - t0
        last = b.fn.rounds.last
        with disable_graphs():
            tw, tmet = b.fn(twin0, x, 0)
        _sync()
        twin_s = time.perf_counter() - t0 - prog_s
    out = {"differs": _differs(st, tw), "same_metrics": _same_metrics(met,
                                                                      tmet),
           "loss": float(met["loss"]), "captured": last["captured"],
           "counts": dict(last["program"].counts or {}), "program_s": prog_s,
           "twin_s": twin_s, "nondeterministic": notes}
    del st, st0, tw, twin0, met, tmet, last, b, x
    repro_torch.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _z_job(job: dict) -> dict:
    """Route z's rank. First :func:`_z_pair` at ``Z_CHECK_SEQ``. Then the
    train step ``steps.build_train_step`` builds for :func:`z_cfg` with the
    dry run's settings on a (1, 1) ("data", "model") mesh, one client of
    batch ``Z_BATCH`` x ``Z_SEQ``: its count on meta (the reckoned peak;
    over ``Z_MAX_GB`` fails), then ``Z_ROUNDS`` calls of ``b.fn`` on the
    card, the launch counters reset before them, under :func:`graph_spy`
    and :func:`program_parts`: the first a warm-up round, the capture and
    a replay, the rest replays. Returns each call's ms and loss, the
    program's report (captured, programs, captures, the replays' ms by
    CUDA events, the graph's nodes by type, the capture's port-kernel
    launches, the first call's parts), the peak memory (above what the
    rank held before), the wrappers' launches (the warm-up's). Then
    ``repro_torch.clear_caches()``: the card empty for the group's next
    jobs."""
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.launch import op_analysis as oa
    from repro_torch.models.params import tree_leaves

    t0 = time.perf_counter()
    pair = _z_pair()
    pair["s"] = time.perf_counter() - t0
    _sync()
    base = torch.cuda.memory_allocated()
    b, init, batch = _z_bundle(Z_SEQ)
    t0 = time.perf_counter()
    meta = oa.analyze(b.fn, *b.abstract_args)
    meta_s = time.perf_counter() - t0
    reck = meta.memory
    reck_gb = (reck["argument_size"] + reck["temp_size"]) / 1e9
    check(reck_gb <= Z_MAX_GB, f"route z: the step reckons {reck_gb:.2f} GB "
          f"on meta, over {Z_MAX_GB}: cut the batch")
    state = init()
    _sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    round_ms, losses = [], []
    with graph_spy() as spy, program_parts() as parts:
        for r in range(Z_ROUNDS):
            x = batch(r)
            _sync()
            t0 = time.perf_counter()
            state, met = b.fn(state, x, r)
            _sync()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            del x
    rounds = b.fn.rounds
    prog = rounds.last["program"]
    types, kernels = (graph_census(prog.graph) if prog.graph is not None
                      else ({}, {}))
    out = {"pair": pair, "round_ms": round_ms, "losses": losses,
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "base_bytes": base, "launches": dict(ops.launches),
           "captured": rounds.last["captured"],
           "programs": len(rounds.programs), "captures": spy["captures"],
           "replay_ms": [e0.elapsed_time(e1) for e0, e1 in spy["events"]],
           "nodes": types, "kernel_nodes": kernels,
           "capture_launches": dict(prog.counts or {}), "parts": parts,
           "finite": all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(state.params)),
           "leaves": len(tree_leaves(b.model.defs())),
           "description": b.description, "reckoned": reck,
           "reckoned_gb": reck_gb, "meta_s": meta_s,
           "meta": {"ops": meta.ops, "flops": meta.flops,
                    "bytes": meta.bytes, "launches": meta.launch_count}}
    del state, met, prog, rounds, b
    repro_torch.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: route lm: ``examples/train_lm_fedcams_torch.py`` on the NCCL rank at
#: these flags (its 100m preset: 12 layers, d_model 768, vocab 8,192, fp32;
#: one client, batch 8 x 128, K = 2, top-k 1/64 over the dense uplink)
LM_EX_ROUNDS = 3
LM_EX_FLAGS = ("--preset", "100m", "--clients", "1", "--tp", "1",
               "--rounds", str(LM_EX_ROUNDS), "--device", "cuda")


def lm_example():
    """``examples/train_lm_fedcams_torch.py`` loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_lm_fedcams_torch",
        ROOT / "examples" / "train_lm_fedcams_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lm_example_job(job: dict) -> dict:
    """Route lm on this NCCL rank, under deterministic algorithms: the LM
    example's ``rank_main`` at :data:`LM_EX_FLAGS` through its per-round
    program (one round captured after a warm-up round, a replay a round;
    under :func:`graph_spy`), then under ``disable_graphs()`` (each eager
    round timed by CUDA events). Returns both runs' losses, which state
    fields differ in any bit, the program's report (captured, programs,
    captures, the replays' ms, the graph's nodes by type, the capture's
    port-kernel launches, the wrappers' launches) and the eager rounds'
    ms."""
    import repro_torch
    from repro_torch.core import mesh as meshmod
    from repro_torch.kernels import ops
    ex = lm_example()
    args = ex.parser().parse_args(list(LM_EX_FLAGS))
    sink, notes, ev = {}, [], []

    def timed(self, *a):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = call(self, *a)
        e1.record()
        ev.append((e0, e1))
        return out

    with nondeterminism_noted(notes), _recording_state(sink):
        ops.reset_launches()
        t0 = time.perf_counter()
        with graph_spy() as spy:
            losses = ex.rank_main(args, device=args.device)
        prog_s = time.perf_counter() - t0
        wrapper = dict(ops.launches)
        rounds, st = sink.pop("rounds"), sink.pop("state")
        prog = rounds.last["program"]
        sink.clear()
        # the recording round (_recording_state's), timed
        call = meshmod.MeshRound.__call__
        meshmod.MeshRound.__call__ = timed
        try:
            t0 = time.perf_counter()
            with disable_graphs():
                twin = ex.rank_main(args, device=args.device)
            twin_s = time.perf_counter() - t0
        finally:
            meshmod.MeshRound.__call__ = call
        tw = sink.pop("state")
    torch.cuda.synchronize()
    types, kernels = graph_census(prog.graph)
    out = {"losses": losses, "twin_losses": twin, "differs": _differs(st, tw),
           "captured": rounds.last["captured"],
           "programs": len(rounds.programs), "captures": spy["captures"],
           "replay_ms": [e0.elapsed_time(e1) for e0, e1 in spy["events"]],
           "eager_ms": [e0.elapsed_time(e1) for e0, e1 in ev],
           "nodes": types, "kernel_nodes": kernels,
           "capture_launches": dict(prog.counts or {}),
           "launches": wrapper, "program_s": prog_s, "twin_s": twin_s,
           "nondeterministic": notes}
    del st, tw, prog, rounds
    sink.clear()
    repro_torch.clear_caches()
    return out


def witness_slstm_train(p, x, num_heads: int, ctx, dtype="bfloat16"):
    """``models/xlstm.slstm_train`` as it stood while its loop read
    ``pre[:, i]`` a step: the backward writes each step's gradient into a
    zero-filled (B, S, 4d) tensor and adds the S of them (bytes quadratic
    in S). Route z's witness of the port's loop over ``pre.unbind(1)``;
    the port never runs it."""
    from repro_torch.launch.op_analysis import loop_steps, loop_trips
    from repro_torch.models import xlstm as xm
    B, S, d = x.shape
    pre = xm._slstm_pre(p, x, dtype, ctx)
    z = pre.new_zeros((B, d))
    st = xm.SLSTMState(h=z, c=z, n=z, m=torch.full_like(z, -1e30))
    rr = xm._recurrent_mats(ctx.tp_copy(p["r"]))
    hs = []
    n = loop_trips(S, pre)
    for i in loop_steps(range(n)):
        st = xm._slstm_step(rr, pre[:, i], st, num_heads)
        hs.append(st.h)
    hs += hs[-1:] * (S - n)
    h = xm.cast(torch.stack(hs, dim=1), dtype)
    return xm._slstm_ffn(p, h, dtype, ctx)


def _z_fwd_bwd(fn, p, x, R):
    """``fn``'s output and the gradients of ∑ out·R for every param of
    ``p`` and for ``x`` (fp32)."""
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.sharding.rules import ParallelContext
    pg = tree_map(lambda t: t.detach().requires_grad_(True), p)
    xg = x.detach().requires_grad_(True)
    out = fn(pg, xg, z_cfg().num_heads, ParallelContext(), "float32")
    grads = torch.autograd.grad((out * R).sum(), tree_leaves(pg) + [xg])
    return [out.detach()] + list(grads)


def z_slstm_case(S: int) -> tuple:
    """One sLSTM layer's params at :func:`z_cfg`'s widths (its bias drawn
    too: the init's is zero), then x and the cotangent R, both
    (``Z_BATCH``, S, d_model) fp32, from a CUDA generator seeded 6."""
    from repro_torch.models import params as pdefs
    from repro_torch.models import xlstm as xm
    cfg, dev = z_cfg(), "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    p = pdefs.init_params(xm.slstm_defs(cfg.d_model, cfg.num_heads,
                                        cfg.xlstm), g, dev)
    p["b"] = torch.randn(p["b"].shape, generator=g, device=dev) * 0.3
    x, R = (torch.randn(Z_BATCH, S, cfg.d_model, generator=g, device=dev)
            for _ in range(2))
    return p, x, R


def _z_slstm() -> dict:
    """One sLSTM layer at xlstm-350m's widths, batch ``Z_BATCH``, fp32,
    ``Z_CHECK_SEQ`` steps: the port's ``slstm_train`` against
    :func:`witness_slstm_train`, the output and the gradients of every
    param and of x equal (``==``, so ±0.0 match; NaN where the witness
    has NaN). ``scripts/slstm_time.py`` times both at ``Z_SEQ``."""
    from repro_torch.models import xlstm as xm
    p, x, R = z_slstm_case(Z_CHECK_SEQ)
    got, want = (_z_fwd_bwd(f, p, x, R)
                 for f in (xm.slstm_train, witness_slstm_train))
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype and a.shape == b.shape and bool(
            ((a == b) | (a.isnan() & b.isnan())).all()),
            f"route z: the sLSTM at S = {Z_CHECK_SEQ}: output/gradient {i} "
            f"differs from the witness's")
    return {"equal_tensors": len(got)}


def _z_counts() -> dict:
    """op_analysis's count of :func:`z_cfg`'s ``Model.loss`` (remat
    "full") and its gradient at batch ``Z_BATCH`` x ``Z_CHECK_SEQ``: one
    full run on the card against meta's, extrapolated from its capped
    sLSTM loop."""
    from repro_torch.launch import op_analysis as oa
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import ParallelContext
    model, dev = Model(z_cfg()), "cuda"
    ctx = ParallelContext()
    params = model.init(torch.Generator(device=dev).manual_seed(7), dev)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, size=(Z_BATCH, Z_CHECK_SEQ + 1)).astype(
            np.int32)).to(dev)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}

    def grad(p, b):
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        loss, _ = model.loss(p, b, ctx, remat_policy="full")
        return torch.autograd.grad(loss, leaves)

    card = oa.measure(grad, params, batch)
    meta = oa.analyze(grad, *_on_meta((params, batch)))
    # the same step run plainly (no recorder): its peak above what was
    # allocated before, against meta's temporaries
    _sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grad(params, batch)
    _sync()
    return {"card": _counts(card), "meta": _counts(meta),
            "memory": meta.memory,
            "plain_peak_temp": torch.cuda.max_memory_allocated() - base}


def route_z(held) -> dict:
    """Route z: xlstm-350m's train_4k round on the card through the step
    builders' program (``launch.programs.TrainStep``), on one NCCL rank
    (:func:`_z_job`). (a) At ``Z_CHECK_SEQ`` the program's round equals
    its eager twin under ``disable_graphs()`` to the bit (deterministic
    algorithms). (b) At one client's share of train_4k (batch ``Z_BATCH``
    x ``Z_SEQ``), ``Z_ROUNDS`` calls: one captured round (one capture,
    a replay a call), its
    graph's port-kernel nodes one ``topk_ef`` and one ``fedams_update`` a
    leaf (as meta counts), the wrappers' launches the warm-up's, at
    shapes phase 1 held; losses and state finite; the peak within
    ``RECKON_TOL`` of op_analysis's reckoning on meta. (c) The sLSTM
    layer's loop over ``pre.unbind(1)`` against the ``pre[:, i]`` witness
    (:func:`_z_slstm`). (d) The card's count of the 2-layer loss and
    gradient equals meta's (:func:`_z_counts`)."""
    card = card_line()
    fed, train = z_configs()
    free, total = torch.cuda.mem_get_info()
    r = shared_ranks("nccl1", "z")[0]["z"]
    pair, parts = r["pair"], r["parts"]
    check(pair["captured"] and not pair["differs"] and pair["same_metrics"],
          f"route z: at {Z_BATCH} x {Z_CHECK_SEQ} the program (captured "
          f"{pair['captured']}) differs from its eager twin in "
          f"{pair['differs']}, metrics the same bits: {pair['same_metrics']}"
          f"; ops without a deterministic implementation: "
          f"{pair['nondeterministic']}")
    n_shapes = check_shapes_held("z", [r], held)
    leaves = r["leaves"]
    want = {"topk_ef": leaves, "fedams_update": leaves}
    check(r["meta"]["launches"] == want, f"route z: meta counts launches "
          f"{r['meta']['launches']}, expected {want}")
    replays = len(r["replay_ms"])
    check(r["captured"] and r["programs"] == 1 and r["captures"] == 1
          and replays == Z_ROUNDS, f"route z: captured {r['captured']}, "
          f"{r['programs']} programs, {r['captures']} captures, {replays} "
          f"replays for {Z_ROUNDS} calls")
    got = {k: v for k, v in r["launches"].items() if v}
    nodes = {k: v for k, v in r["kernel_nodes"].items() if v}
    captured = {k: v for k, v in r["capture_launches"].items() if v}
    check(got == want and nodes == want and captured == want
          and pair["counts"] == dict(r["capture_launches"]),
          f"route z: the warm-up's launches {got}, the graph's port-kernel "
          f"nodes {nodes}, the capture's launches {captured} (at "
          f"{Z_CHECK_SEQ}: {pair['counts']}), expected {want} ({leaves} "
          f"leaves a round)")
    check(all(np.isfinite(r["losses"])) and r["finite"],
          f"route z: losses {r['losses']} or a non-finite state")
    peak = r["peak_bytes"] / 1e9
    check(abs(peak - r["reckoned_gb"]) <= RECKON_TOL * r["reckoned_gb"],
          f"route z: peak {peak:.4f} GB against the reckoned "
          f"{r['reckoned_gb']:.4f} GB on meta: more than {RECKON_TOL:.0%} "
          f"apart")
    graph = {k: v * replays for k, v in r["kernel_nodes"].items()}
    first = r["round_ms"][0] / 1e3
    seconds = {"rank_job": r["job_s"], "pair": pair["s"],
               "meta": r["meta_s"], "first_call": first,
               "replays": sum(r["round_ms"][1:]) / 1e3}
    print(f"route z [{card}]: xlstm-350m, {Z_LAYERS} layers, "
          f"{r['description']} through steps.build_train_step's TrainStep, "
          f"batch {Z_BATCH} x {Z_CHECK_SEQ} on one NCCL rank, deterministic "
          f"algorithms: the program's round (captured) equals its eager "
          f"twin under disable_graphs() to the bit (params, m, v, v-hat, "
          f"the EF row, the metrics); loss {pair['loss']}; the program's "
          f"call {pair['program_s']:.1f} s, the twin's {pair['twin_s']:.1f}"
          f" s")
    print(f"route z [{card}]: xlstm-350m, {Z_LAYERS} layers, batch "
          f"{Z_BATCH} x {Z_SEQ} on one NCCL rank (fedcams, "
          f"{fed.compressor} {fed.compress_ratio:g} over the "
          f"{fed.aggregation} uplink, K = {fed.local_steps}, remat "
          f"{train.remat_policy}), {Z_ROUNDS} calls of b.fn: captured "
          f"{r['captured']}; the graph's nodes {r['nodes']}; its port-kernel "
          f"nodes {nodes} (read from the driver; the capture's launches, "
          f"ops.captured_launches, the same); the first call "
          f"{first:.1f} s: the warm-up round "
          f"{parts['warmup_event_ms'][0]:.1f} ms by CUDA events "
          f"({parts['warmup_s'][0]:.1f} s to a synchronize), the capture "
          f"{parts['capture_s'][0]:.1f} s and the instantiation "
          f"{parts['instantiate_s'][0]:.1f} s of host time; the replays' ms "
          f"(CUDA events) {[round(t, 2) for t in r['replay_ms']]}; calls' "
          f"ms (host) {[round(t, 1) for t in r['round_ms']]}; losses "
          f"{r['losses']}; peak {peak:.4f} GB, reckoned on meta "
          f"{r['reckoned_gb']:.4f} GB, within {RECKON_TOL:.0%} "
          f"({r['reckoned']}; {r['meta_s']:.1f} s); meta counts "
          f"{r['meta']['ops']:,} ops, {r['meta']['flops']:.4g} FLOPs, "
          f"{r['meta']['bytes']:,} bytes a round; graph launches "
          f"{graph}; distinct launch shapes, each held by phase 1: "
          f"{n_shapes}; {free / 1e9:.1f} of {total / 1e9:.1f} GB free "
          f"before")
    t0 = time.perf_counter()
    sl = _z_slstm()
    gc.collect()
    torch.cuda.empty_cache()
    seconds["slstm_witness"] = time.perf_counter() - t0
    print(f"route z [{card}]: one sLSTM layer, batch {Z_BATCH}, fp32: at S "
          f"= {Z_CHECK_SEQ} the output and {sl['equal_tensors'] - 1} "
          f"gradients equal the pre[:, i] witness's (==)")
    t0 = time.perf_counter()
    counts = _z_counts()
    gc.collect()
    torch.cuda.empty_cache()
    seconds["counts"] = time.perf_counter() - t0
    check(counts["card"] == counts["meta"], f"route z: the card's count of "
          f"the {Z_LAYERS}-layer loss + gradient {counts['card']} != meta's "
          f"{counts['meta']}")
    mem = counts["memory"]
    small = (mem["argument_size"] + counts["plain_peak_temp"],
             mem["argument_size"] + mem["temp_size"])
    check(abs(small[0] - small[1]) <= RECKON_TOL * small[1],
          f"route z: the loss + gradient at {Z_BATCH} x {Z_CHECK_SEQ} "
          f"peaks at {small[0]:,} bytes (arguments + the plain run's peak "
          f"above them) against {small[1]:,} reckoned on meta: more than "
          f"{RECKON_TOL:.0%} apart")
    print(f"route z [{card}]: op_analysis on the card = on meta (ops, FLOPs, "
          f"bytes, rw bytes, collective bytes) for the {Z_LAYERS}-layer "
          f"Model.loss + gradient at {Z_BATCH} x {Z_CHECK_SEQ}: "
          f"{counts['card']}; run plainly it peaks at {small[0]:,} bytes "
          f"(arguments {mem['argument_size']:,} + {counts['plain_peak_temp']:,}"
          f"), meta reckons {small[1]:,} (temporaries {mem['temp_size']:,}): "
          f"{small[0] / small[1]:.4f} of it; seconds by part "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return {"card": card, "losses": r["losses"], "round_ms": r["round_ms"],
            "replay_ms": r["replay_ms"], "nodes": r["nodes"], "parts": parts,
            "pair": pair, "peak_gb": peak, "reckoned_gb": r["reckoned_gb"],
            "reckoned": r["reckoned"], "meta": r["meta"],
            "shapes_held": n_shapes, "slstm": sl, "counts": counts["card"],
            "small_step_peak_vs_reckoned": small, "part_seconds": seconds,
            "launches": r["launches"], "graph_launches": graph}


def route_lm(held) -> dict:
    """Route lm: ``examples/train_lm_fedcams_torch.py``'s ``rank_main`` on
    the NCCL rank (:func:`_lm_example_job`): through its per-round program
    one captured round, a replay a round, the losses and the final state
    to the bit its ``disable_graphs()`` twin's under deterministic
    algorithms; the capture's port kernels the warm-up's launches, at
    shapes phase 1 held; the replays' ms beside the eager rounds'."""
    card = card_line()
    r = shared_ranks("nccl1", "lm")[0]["lm"]
    n_shapes = check_shapes_held("lm", [r], held)
    replays = len(r["replay_ms"])
    check(r["captured"] and r["programs"] == 1 and r["captures"] == 1
          and replays == LM_EX_ROUNDS, f"route lm: captured {r['captured']}, "
          f"{r['programs']} programs, {r['captures']} captures, {replays} "
          f"replays for {LM_EX_ROUNDS} rounds")
    check(not r["differs"] and r["losses"] == r["twin_losses"],
          f"route lm: the program's state differs from the twin's in "
          f"{r['differs']}; losses {r['losses']} vs {r['twin_losses']}; "
          f"ops without a deterministic implementation: "
          f"{r['nondeterministic']}")
    got = {k: v for k, v in r["launches"].items() if v}
    nodes = {k: v for k, v in r["kernel_nodes"].items() if v}
    captured = {k: v for k, v in r["capture_launches"].items() if v}
    check(got == nodes == captured and nodes, f"route lm: the warm-up's "
          f"launches {got}, the graph's port-kernel nodes {nodes}, the "
          f"capture's launches {captured}")
    check(all(np.isfinite(r["losses"])), f"route lm: losses {r['losses']}")
    graph = {k: v * replays for k, v in r["kernel_nodes"].items()}
    replay = float(np.median(r["replay_ms"][1:]))
    eager = float(np.median(r["eager_ms"][1:]))
    print(f"route lm [{card}]: examples/train_lm_fedcams_torch.py "
          f"{' '.join(LM_EX_FLAGS)} on one NCCL rank, deterministic "
          f"algorithms: losses {r['losses']}, equal to the disable_graphs() "
          f"twin's, and the final params, m, v, v-hat and EF row to the bit; "
          f"captured {r['captured']}, the graph's nodes {r['nodes']}, its "
          f"port-kernel nodes {nodes}; the replays' ms (CUDA events) "
          f"{[round(t, 3) for t in r['replay_ms']]} (median of 1.. "
          f"{replay:.3f}) against the eager rounds' "
          f"{[round(t, 3) for t in r['eager_ms']]} (median of 1.. "
          f"{eager:.3f}): {eager / replay:.2f}x; the program's run "
          f"{r['program_s']:.1f} s, the twin's {r['twin_s']:.1f} s; distinct "
          f"launch shapes, each held by phase 1: {n_shapes}; the job "
          f"{r['job_s']:.1f} s")
    return {"card": card, "losses": r["losses"], "replay_ms": r["replay_ms"],
            "eager_ms": r["eager_ms"], "nodes": r["nodes"],
            "shapes_held": n_shapes, "launches": r["launches"],
            "graph_launches": graph}


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

    import repro_torch
    from repro_torch.kernels import _build
    t_start = t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    seconds = {"build": build_s}
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
        large.update(phase_z_shapes(dev, mesh_held))
    torch.cuda.empty_cache()
    seconds["phase 1"] = time.perf_counter() - t_phase
    print(f"phase 1 took {seconds['phase 1']:.1f} s")
    for name, (cases, worst, sigs) in mesh_held.items():
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], worst)
        kern[name]["cases_routes_m_o_q"] = cases
        print(f"kernel {name} vs twin at routes m, o-w and z's shapes: "
              f"{cases} "
              f"cases, {len(sigs)} shapes, bitwise")
    for d, row in large.items():
        for name in (n for n in row if n != "route"):
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
    seconds["phase 2"] = time.perf_counter() - t_phase
    print(f"phase 2 took {seconds['phase 2']:.1f} s")
    t_phase = time.perf_counter()
    block = phase_block()
    seconds["block"] = time.perf_counter() - t_phase
    print(f"the block part took {seconds['block']:.1f} s")
    t_phase = time.perf_counter()
    sl = phase_slice()
    seconds["phase 3"] = time.perf_counter() - t_phase
    seconds["phase 3, run_rounds"] = sl["run_rounds_s"]
    print(f"phase 3 took {seconds['phase 3']:.1f} s")
    # local training on the card is bit-reproducible only under
    # deterministic algorithms, which route a's run_rounds part ran under
    # (its rounds, eager and through the graph): its final state is the
    # one to hold equal to another build's to the bit
    det = sl["run_rounds"]["a"]
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
    seconds["route m"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    m1 = route_m1(mesh_held)
    seconds["route m1"] = time.perf_counter() - t_phase
    print(f"routes m and m1 took {seconds['route m']:.1f} and "
          f"{seconds['route m1']:.1f} s")
    #: the model routes in order (serving, then training, a family at a
    #: time), and the rounds each training route runs
    model_routes = {"n": route_n, "o": lambda: route_o(mesh_held),
                    "o1": lambda: route_o1(mesh_held), "p": route_p, "q": lambda: route_q(mesh_held),
                    "r": route_r, "s": lambda: route_s(mesh_held),
                    "t": route_t, "u": lambda: route_u(mesh_held),
                    "v": route_v, "w": lambda: route_w(mesh_held),
                    "x": route_x, "y": route_y,
                    "z": lambda: route_z(mesh_held),
                    "lm": lambda: route_lm(mesh_held)}
    lm_rounds = {"o": LM_ROUNDS, "q": MOE_ROUNDS, "s": MLA_ROUNDS,
                 "u": RG_ROUNDS, "w": W_ROUNDS, "z": Z_ROUNDS,
                 "lm": LM_EX_ROUNDS}
    zoo = {}
    for route, fn in model_routes.items():
        t_phase = time.perf_counter()
        zoo[route] = fn()
        zoo[route]["seconds"] = seconds[f"route {route}"] = (
            time.perf_counter() - t_phase)
        print(f"route {route} took {zoo[route]['seconds']:.1f} s")
        repro_torch.clear_caches()
        gc.collect()
        torch.cuda.empty_cache()

    rows = []
    for name, r in kern.items():
        # phase 3's rounds replay the round's programs: the wrappers
        # launched in their warm-ups (and in the eager twins); a round's
        # launches are the graphs' kernel nodes × replays, kept apart
        runs = [(route, sl[route]["launches"][name]) for route in ROUTES]
        per_round = {route: sl[route]["graph_launches"][name] / ROUNDS
                     for route in ROUTES
                     if sl[route]["graph_launches"][name]}
        in_graph = sum(sl[route]["graph_launches"][name] for route in ROUTES)
        kp, jp = sl["k"]["programs"], sl["j"]["programs"]
        runs.append(("k programs", kp["eager"][name] + kp["wrapper"][name]))
        in_graph += kp["graph"][name] + jp["graph_launches"][name]
        # run_rounds' wrapper launches (its eager loops and warm-ups) count;
        # the graph's are read from its kernel nodes and kept apart
        rr = sl["run_rounds"].values()
        wrapped = sum(x["launches_wrapper"][name] for x in rr)
        in_graph += sum(x["launches_in_graph"][name] for x in rr)
        runs.append(("run_rounds", wrapped))
        if wrapped:
            per_round["run_rounds and round pairs (all, eager + warm-up)"] = (
                wrapped)
            per_round["run_rounds and round pairs (all, graph nodes x "
                      "replays)"] = sum(x["launches_in_graph"][name]
                                        for x in rr)
        mesh_n = sum(j["launches"][name] for j in mesh_res.values())
        runs += [("m", mesh_n), ("m1", m1["launches"][name]),
                 ("o1", zoo["o1"]["launches"][name])]
        runs += [(route, zoo[route]["launches"][name]) for route in lm_rounds]
        if mesh_n or m1["launches"][name]:
            per_round["m (all jobs, all ranks)"] = mesh_n
            per_round["m1 (eager rounds + program warm-ups)"] = (
                m1["launches"][name])
        # the mesh programs' graphs (m1's and o1's): nodes × replays, apart
        for route, res in (("m1", m1["graph"]), ("o1", zoo["o1"])):
            if res["graph_launches"][name]:
                in_graph += res["graph_launches"][name]
                per_round[f"{route} (graph nodes x replays, both modes)"] = (
                    res["graph_launches"][name])
        if zoo["o1"]["launches"][name]:
            per_round["o1 (eager rounds + program warm-ups)"] = (
                zoo["o1"]["launches"][name])
        for route, rounds in lm_rounds.items():
            # q, s and u replay train's per-round graph: a round's
            # launches are its nodes (the wrappers': the warm-up round's)
            graph = zoo[route].get("graph_launches", {}).get(name, 0)
            in_graph += graph
            if graph:
                per_round[f"{route} (a replay, graph nodes)"] = graph / rounds
            elif zoo[route]["launches"][name]:
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
            "graph_launches": in_graph,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"]})
    seconds["all"] = time.perf_counter() - t_start
    seconds["graph censuses, this process"] = DUMP_S[0]
    print(f"seconds by phase and route: "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "seconds": seconds,
         "build_s": build_s, "kernels": kern, "kernel_rows": rows,
         "reference": refcheck, "block": block, "slice": sl,
         "route_a_deterministic": det, "mesh": mesh_res, "mesh_m1": m1,
         "zoo": zoo},
        indent=1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
