"""Where a FedCAMS round of the PyTorch port spends its time on the card.

    python3 scripts/profile_round.py [route ...]

Runs the configuration of ``chip_smoke.py`` (ConvMixer-256-8, fedcams,
m = 100, n = 10, K = 3, batch 20, TF32 off) on the named routes of
``chip_smoke.py`` (default: all of them), each built by its
``_route_cfg`` (and, for h and i, its ``route_fault``, from this run's
cohorts):

    a  blocktopk 1/64, track_gamma=False: topk_ef_sparse + fedams_ingest
    b  blocktopk 1/64, track_gamma=True: topk_ef_sparse + fedams_update
    c  sign, in memory: sign_ef + fedams_update
    d  sign over the packed wire: pack_uint/unpack_uint (n = 1, fused)
    e  blocktopk 1/64, dense uplink: topk_ef + fedams_update
    f  as e over the packed wire: pack_uint/unpack_uint (n = 11)
    g  sign over the wire with the two-way downlink and
       ``examples/quickstart_wire.py``'s network: pack_uint/unpack_uint
       twice a round (uplink block, downlink message). ``chip_smoke.py``
       drives it through ``FederatedTrainer.run``; here its FedSim rounds
       are driven directly (the trainer adds the host-side draw of the ids
       and batches, outside the round)
    h  blocktopk 1/64 over the wire with crashes, bit flips and a deadline:
       topk_ef_sparse + the survivor-masked aggregate + fedams_update
    i  sign in memory with a scheduled crash, NaN payloads and a norm
       clip: sign_ef + validation + fedams_update
    j  blocktopk 1/64 over the wire through the async buffered engine
       (B = 5 of n = 10): topk_ef_sparse once a cohort, fedams_ingest once
       a flush. Each step here is a ``run_rounds`` call over the step's
       cohorts, which drains them, so per-round numbers are per cohort
    k  blocktopk 1/64 over the wire, m = 1,000 with the host-side EF
       store, client_chunk=5 and agg_groups=2: topk_ef_sparse twice a
       round, the grouped scatter + fedams_update; the store's gather and
       scatter run in the ``ef_store`` ranges
    l  randk 1/64 in memory, γ on, client_chunk=5: fedams_update
    m  the mesh backend: chip_smoke.py's route m job ``sparse-3of4``
       (ConvMixer-256-8's per-leaf tree, fedcams blocktopk 1/64 over the
       sparse client-axis collective, n = 3 of m = 4, topk_ef_sparse +
       fedams_ingest per leaf) on four gloo ranks sharing the card; the
       stages are the round's ``mesh.<stage>`` ranges, with every
       collective in a nested ``mesh.collective`` range whose host time is
       what the gloo collectives block for; reported for rank 0. Before
       the rounds, the same four ranks time gloo's collectives on CUDA
       tensors alone: a list ``all_gather`` and an ``all_reduce`` of 11,008
       (a ConvMixer leaf's selections on the flat model) and 704,266 fp32
       (the whole model), and whether ``all_gather_into_tensor`` is taken
    n  serving: chip_smoke.py's route n at batch 4, prompt 512, gen 32
       (gemma2-2b at its published widths, 26 layers, seeded weights)
       through ``launch/serve.py``'s ``generate``: a warm-up call, 3
       unprofiled (prefill ms, decode ms a token), one profiled; its stages
       are the ``serve.prefill`` / ``serve.decode`` ranges, and by layer
       the ``model.<layer>`` ranges (embed, attention, ffn, unembed), each
       with its kernel launches
    p  serving the MoE: chip_smoke.py's route p at batch 4, prompt 512,
       gen 32 (qwen2-moe-a2.7b at its published widths, 24 layers, seeded
       weights), as n; by layer also ``model.moe`` (router, dispatch,
       expert einsums), ``model.moe_scatter`` (the expert-by-expert
       ``index_add_``) and ``model.ffn`` (the shared experts)
    r  serving MLA: chip_smoke.py's route r at batch 4, prompt 512, gen 32
       (deepseek-v3-671b at its published widths, 1 layer, no MTP block,
       weights drawn on the card), as p; ``model.attention`` is MLA (the
       decompressed prefill, the absorbed decode)
    t  serving the hybrid: chip_smoke.py's route t at batch 4, prompt 512,
       gen 32 (recurrentgemma-2b at its published widths, 26 layers), as
       n; by layer also ``model.rglru`` (the gated conv, the gates and the
       scan or the decode step)
    v  serving the xLSTM: chip_smoke.py's route v at batch 4, prompt 512,
       gen 32 (xlstm-350m at its published widths and depth, 24 layers,
       bf16 compute), as n; by layer ``model.mlstm`` (the projections and
       the quadratic form or the recurrent step) and ``model.slstm`` (the
       sequential steps, the norm and the FFN, whose ``model.ffn`` nests
       inside it)
    o  federated LM training: chip_smoke.py's route o (gemma2-2b widths, 2
       layers, 2 gloo ranks sharing the card) through ``launch/train.py``'s
       ``train``, WARMUP + TIMED + PROFILED rounds with rank 0 under the
       profiler throughout (its TIMED rounds are the "unprofiled" ones
       here, so they carry the profiler's host cost); the last PROFILED
       rounds' ``train.round`` windows are kept; stages are the
       ``mesh.<stage>`` ranges (with ``mesh.collective`` nested), rank 0

After a warm-up round:

* rounds 1-3 unprofiled: wall ms per round (host clock, synchronized);
* rounds 4-6 under ``torch.profiler``, per round: for each stage that
  ``FedSim`` marks with a ``fedsim.<stage>`` range (host → device, local
  training, uplink — with ``encode``/``decode`` nested inside it on the
  wire routes — server ingest, or aggregate + γ + ``server_update``,
  downlink), the device time of the kernels launched while the range was
  open — the innermost open range, from any host thread, so the autograd
  engine's backward kernels count for local training — and the host time
  of the range (inflated by the profiler); device time by kernel, the top
  15 and each of the port's own (``csrc/``) kernels; and the device's busy
  time (summed kernel time; one stream, so kernels do not
  overlap) against the unprofiled round.

Kernels are matched to their launches through the trace's correlation ids
(``export_chrome_trace``), which also covers the kernels the port launches
through ctypes. Prints a summary and writes
``chiprun_out/profile_round.json``. Needs CUDA.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

M, N_CLI, K_STEPS, BATCH = (chip_smoke.M, chip_smoke.N_CLI, chip_smoke.K_STEPS,
                            chip_smoke.BATCH)
#: the __global__ functions of src/repro_torch/kernels/csrc/
PORT_KERNELS = ("topk_ef_sparse_kernel", "topk_ef_kernel", "sign_ef_kernel",
                "pack_bits_kernel", "pack_groups_kernel",
                "unpack_bits_kernel", "unpack_groups_kernel",
                "fedams_ingest_kernel", "fedams_update_kernel")
WARMUP, TIMED, PROFILED = 1, 3, 3


def _sim(route: str, plan, m: int):
    from repro_torch.core.sim import FedSim
    from repro_torch.models import convmixer as cm
    from repro_torch.models.params import count_params, init_params
    cfg = cm.ConvMixerConfig()
    defs = cm.convmixer_defs(cfg)
    loss = lambda p, b: cm.convmixer_loss(p, b, cfg)
    p0 = init_params(defs, torch.Generator().manual_seed(0))
    fault = chip_smoke.route_fault(route, plan, m, N_CLI, K_STEPS,
                                   count_params(defs), loss, p0, "cuda")
    sim = FedSim(loss, chip_smoke._route_cfg(route, m, N_CLI, K_STEPS, fault),
                 network=chip_smoke.wire_network(m) if route in ("g", "j")
                 else None)
    return sim, sim.init(p0), fault


def _run(sim, st, plan):
    """The rounds of ``plan`` from ``st``: one ``run_rounds`` call through
    the async engine on route j, else a ``FedSim.round`` a round with a
    generator (randk's draws) and the next round's ids (the EF store's
    prefetch). The rounds run their eager bodies
    (``repro_torch.disable_graphs``): a replayed graph has no stage
    ranges to break the round down by."""
    from repro_torch import disable_graphs
    with disable_graphs():
        if sim._async is not None:
            ids, batches = chip_smoke.stacked(plan)
            return sim.run_rounds(st, batches, ids)[0]
        for r, (idx, b) in enumerate(plan):
            st, _ = sim.round(st, b, idx, torch.Generator().manual_seed(r),
                              prefetch_idx=plan[r + 1][0]
                              if r + 1 < len(plan) else None)
    return st


def _trace_events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _breakdown(events, rounds: int, prefix: str = "fedsim."):
    """Per stage (a ``<prefix><stage>`` range): summed device time of the
    kernels launched inside it (the innermost range open at the launch) and
    the host time of its range; per kernel name: count and device time.
    All per round."""
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(prefix):])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(prefix))
    starts = [s[0] for s in stages]

    def innermost(ts):
        """The latest-starting range that is still open at ``ts``."""
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and stages[i][1] < ts:
            i -= 1
        return stages[i][2] if i >= 0 else "(outside the stages)"

    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    stage_dev = defaultdict(float)
    stage_n = defaultdict(int)
    stage_host = defaultdict(float)
    for t0, t1, name in stages:
        stage_host[name] += (t1 - t0) / 1e3
    by_kernel = defaultdict(lambda: [0, 0.0])
    busy = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ms = e["dur"] / 1e3
        busy += ms
        by_kernel[e["name"]][0] += 1
        by_kernel[e["name"]][1] += ms
        ts = launch_ts.get(e["args"].get("correlation"))
        where = (innermost(ts) if ts is not None
                 else "(outside the stages)")
        stage_dev[where] += ms
        stage_n[where] += 1
    stage_ms = {name: {"device_ms": stage_dev.get(name, 0.0) / rounds,
                       "host_ms": stage_host.get(name, 0.0) / rounds,
                       "launches": stage_n.get(name, 0) / rounds}
                for name in dict.fromkeys(s[2] for s in stages)}
    if "(outside the stages)" in stage_dev:
        stage_ms["(outside the stages)"] = {
            "device_ms": stage_dev["(outside the stages)"] / rounds,
            "host_ms": None,
            "launches": stage_n["(outside the stages)"] / rounds}
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    per_round = lambda kv: {"name": kv[0][:90], "count": kv[1][0] / rounds,
                            "device_ms": kv[1][1] / rounds}
    return stage_ms, busy / rounds, [per_round(kv) for kv in rows[:15]], [
        per_round(kv) for kv in rows if any(f in kv[0] for f in PORT_KERNELS)]


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_round.py needs CUDA")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sampling import sample_clients
    from repro_torch.data.synthetic import FederatedClassification
    torch.backends.cudnn.allow_tf32 = False     # as chip_smoke.py runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    datasets = {m: FederatedClassification(num_clients=m,
                                           image_shape=(32, 32, 3),
                                           alpha=0.3, seed=0)
                for m in (M, chip_smoke.M_K)}
    gen = torch.Generator().manual_seed(1)
    known = list(chip_smoke.ROUTES) + ["m", "n", "o", "p", "r", "t", "v"]
    routes = sys.argv[1:] or known
    unknown = [r for r in routes if r not in known]
    if unknown:
        sys.exit(f"profile_round.py: unknown route(s) {unknown}; "
                 f"routes are {known}")
    out = {"card": chip_smoke.card_line()}
    print(out["card"])
    if "m" in routes or "o" in routes:
        from repro_torch.kernels import _build
        _build.build_all()    # before the ranks start, which load it
    for route in routes:
        if route in ("m", "n", "o", "p", "r", "t", "v"):
            out[route] = _mesh() if route == "m" else (
                _lm() if route == "o" else _serve(route))
            continue
        m = chip_smoke.M_K if route == "k" else M
        plan = []
        for r in range(WARMUP + TIMED + PROFILED):
            idx = sample_clients(gen, m, N_CLI).numpy()
            plan.append((idx, datasets[m].round_batches(idx, r, K_STEPS,
                                                        BATCH)))
        sim, st, fault = _sim(route, plan, m)
        if fault is not None:
            print(f"route {route}: {fault}")
        st = _run(sim, st, plan[:WARMUP])
        torch.cuda.synchronize()
        wall = []
        for step in plan[WARMUP:WARMUP + TIMED]:
            t0 = time.perf_counter()
            st = _run(sim, st, [step])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st = _run(sim, st, plan[WARMUP + TIMED:])
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / PROFILED
        out[route] = _print_breakdown(route, _trace_events(prof), wall,
                                      prof_wall)
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "profile_round.json").write_text(json.dumps(out, indent=1))


def _collective_probe(job):
    """Rank side of the gloo probe: each collective on fp32 CUDA tensors
    over the world, median host ms of 10 (after 3 warm-ups and a
    barrier, synchronized after each), and whether
    ``all_gather_into_tensor`` is taken."""
    import torch.distributed as dist
    world = dist.get_world_size()
    res = {}
    for n in job["sizes"]:
        x = torch.randn(n, device="cuda")
        parts = [torch.empty_like(x) for _ in range(world)]
        for name, fn in (("all_gather", lambda: dist.all_gather(parts, x)),
                         ("all_reduce", lambda: dist.all_reduce(x))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            dist.barrier()
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            res[f"{name} {n} fp32 ms"] = statistics.median(ts)
    out = torch.empty(world * 4, device="cuda")
    try:
        dist.all_gather_into_tensor(out, torch.zeros(4, device="cuda"))
        res["all_gather_into_tensor"] = "taken"
    except RuntimeError as e:
        res["all_gather_into_tensor"] = f"refused: {str(e)[:160]}"
    return res


def _mesh():
    """Route m: the gloo probe, then WARMUP + TIMED + PROFILED rounds on
    four gloo ranks, the last PROFILED under the profiler; rank 0's trace
    and round times."""
    probe = chip_smoke.run_ranks(chip_smoke.M_MESH, "gloo", {"probe": {
        "sizes": (11008, 704266)}}, fn=_collective_probe)[0]["probe"]
    print(f"route m: gloo on CUDA tensors, {chip_smoke.M_MESH} ranks on one "
          f"card: {probe}")
    job = dict(chip_smoke.mesh_jobs()["sparse-3of4"],
               rounds=WARMUP + TIMED + PROFILED, profile_last=PROFILED,
               trace=True)
    r0 = chip_smoke.run_ranks(chip_smoke.M_MESH, "gloo", {"m": job})[0]["m"]
    wall = r0["round_ms"][WARMUP:WARMUP + TIMED]
    prof_wall = sum(r0["round_ms"][WARMUP + TIMED:]) / PROFILED
    res = _print_breakdown("m", r0["trace"], wall, prof_wall, prefix="mesh.")
    coll = res["stage_ms"].get("collective", {})
    print(f"route m: the gloo collectives block rank 0's host "
          f"{coll.get('host_ms')} ms a round (device time inside them "
          f"{coll.get('device_ms')} ms)")
    res["gloo_probe"] = probe
    return res


def _serve(route):
    """Route n (p, r, t, v): ``generate`` on gemma2-2b (qwen2-moe-a2.7b,
    deepseek-v3-671b at 1 layer, recurrentgemma-2b, xlstm-350m at bf16)
    at full width, batch 4, prompt 512, gen 32 — a warm-up call, TIMED
    unprofiled, one profiled."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import mreplace
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    batch, prompt, gen = (chip_smoke.MOE_SERVE_RUNS if route == "p" else
                          chip_smoke.SERVE_RUNS)[0][:3]
    arch = {"n": "gemma2-2b", "p": "qwen2-moe-a2.7b",
            "r": "deepseek-v3-671b", "t": "recurrentgemma-2b",
            "v": "xlstm-350m"}[route]
    cfg = get_arch(arch).model
    generator = torch.Generator().manual_seed(0)
    if route == "r":      # chip_smoke.route_r's cut, drawn on the card
        cfg = mreplace(cfg, num_layers=chip_smoke.MLA_SERVE_LAYERS, mtp=None)
        generator = torch.Generator(device="cuda").manual_seed(0)
    model = Model(cfg)
    params = model.init(generator, "cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(batch, prompt)).astype(np.int32)
    quiet = lambda line: None
    generate(model, params, prompts, gen, log=quiet)
    runs = [generate(model, params, prompts, gen, log=quiet)
            for _ in range(TIMED)]
    wall = [(r["prefill_s"] + r["decode_s"]) * 1e3 for r in runs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = generate(model, params, prompts, gen, log=quiet)
        torch.cuda.synchronize()
    events = _trace_events(prof)
    res = _print_breakdown(route, events, wall,
                           (r["prefill_s"] + r["decode_s"]) * 1e3,
                           prefix="serve.", rounds=1)
    layers, _, _, _ = _breakdown(events, 1, "model.")
    res["layer_ms"] = layers
    res["prefill_ms"] = [x["prefill_s"] * 1e3 for x in runs]
    res["decode_ms_per_token"] = [x["decode_s"] * 1e3 / (gen - 1)
                                  for x in runs]
    print(f"route {route}: prefill ms {res['prefill_ms']}, decode ms a "
          f"token {res['decode_ms_per_token']}")
    for name, t in layers.items():
        print(f"  layer {name:22s} device {t['device_ms']:9.3f} ms  "
              f"host {t['host_ms']} ms  launches {t['launches']:g}")
    return res


def _in_windows(events, windows):
    """The events of ``events`` inside ``windows`` ((start, end) host µs):
    ranges and runtime calls by their start, kernels by their launch."""
    inside = lambda ts: any(a <= ts <= b for a, b in windows)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    keep = []
    for e in events:
        if e.get("cat") == "kernel":
            ts = launch.get(e.get("args", {}).get("correlation"))
        else:
            ts = e.get("ts")
        if ts is not None and inside(ts):
            keep.append(e)
    return keep


def _lm_job(job):
    """Rank side of route o: ``train`` for WARMUP + TIMED + PROFILED
    rounds, rank 0 under the profiler (rank 1 unprofiled, so the two
    contexts' load is as in ``chip_smoke.py``); rank 0 keeps the trace of
    its last PROFILED ``train.round`` windows."""
    import contextlib
    import dataclasses

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as ttrain
    rank0 = dist.get_rank() == 0
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if rank0 else contextlib.nullcontext())
    with prof:
        out = ttrain.train(job["cfg"], job["fed"], dataclasses.replace(
            job["train"], rounds=WARMUP + TIMED + PROFILED), device="cuda",
            log=None)
    res = {"round_ms": [h["round_s"] * 1e3 for h in out["history"]],
           "peak_bytes": out["peak_bytes"]}
    if rank0:
        events = _trace_events(prof)
        windows = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") == "user_annotation"
                         and e["name"] == ttrain.ROUND_RANGE)[-PROFILED:]
        res["trace"] = _in_windows(events, windows)
    return res


def _lm():
    """Route o: chip_smoke.py's configuration, rank 0's breakdown."""
    from repro_torch.configs.base import TrainConfig
    job = dict(cfg=chip_smoke.lm_cfg(), fed=chip_smoke.lm_fed(),
               train=TrainConfig(global_batch=2 * chip_smoke.LM_CLIENTS,
                                 seq_len=512, remat_policy="none"))
    with chip_smoke.expandable_segments():
        r0 = chip_smoke.run_ranks(chip_smoke.LM_CLIENTS, "gloo", {"o": job},
                                  fn=_lm_job, timeout=1500)[0]["o"]
    wall = r0["round_ms"][WARMUP:WARMUP + TIMED]
    prof_wall = statistics.mean(r0["round_ms"][WARMUP + TIMED:])
    res = _print_breakdown("o", r0.pop("trace"), wall, prof_wall,
                           prefix="mesh.")
    res["peak_bytes_rank0"] = r0["peak_bytes"]
    coll = res["stage_ms"].get("collective", {})
    print(f"route o: the gloo collectives block rank 0's host "
          f"{coll.get('host_ms')} ms a round; peak memory rank 0 "
          f"{r0['peak_bytes'] / 1e9:.2f} GB")
    return res


def _print_breakdown(route, events, wall, prof_wall, prefix="fedsim.",
                     rounds=PROFILED):
    """Print and return one route's breakdown (see ``_breakdown``) beside
    its unprofiled round times ``wall`` and profiled round ``prof_wall``;
    ``rounds`` is the number of rounds (calls) the trace holds."""
    stage_ms, busy, top, port = _breakdown(events, rounds, prefix)
    round_ms = statistics.median(wall)
    res = {"round_ms": wall, "round_ms_median": round_ms,
           "rounds_profiled": rounds, "profiled_round_wall_ms": prof_wall,
           "stage_ms": stage_ms, "device_busy_ms": busy,
           "device_busy_share_of_unprofiled_round": busy / round_ms,
           "top_kernels": top, "port_kernels": port}
    print(f"route {route}: unprofiled round ms {wall} (median "
          f"{round_ms:.1f}); profiled {prof_wall:.1f} ms")
    for name, t in stage_ms.items():
        print(f"  stage {name:22s} device {t['device_ms']:9.3f} ms  "
              f"host {t['host_ms']} ms  launches {t['launches']:g}")
    print(f"route {route}: device busy {busy:.1f} ms per round, "
          f"{100 * busy / round_ms:.1f} % of the unprofiled round")
    for row in top:
        print(f"  {row['device_ms']:9.3f} ms  x{row['count']:<7g} "
              f"{row['name']}")
    print(f"route {route}: the port's own kernels, per round")
    for row in port:
        print(f"  {row['device_ms']:9.4f} ms  x{row['count']:<7g} "
              f"{row['name']}")
    return res


if __name__ == "__main__":
    main()
