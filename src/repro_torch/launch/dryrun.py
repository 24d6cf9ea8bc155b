"""Multi-pod dry run: build every (architecture × input shape) step on the
production meshes, trace rank 0's program on ``meta`` tensors and extract
roofline terms.

Counterpart of ``repro.launch.dryrun``, with the same flags and the same
resumable JSON keyed ``tag/mesh/arch/shape`` (default
``results/dryrun_torch.json``). The reference lowers and compiles each
step on 512 forced host devices; here one process starts the ``fake``
process group as rank 0 of 256 or 512 ranks (``launch.mesh.
start_fake_world``), builds the step (``launch.steps``) over the
production mesh, and runs it once on ``meta`` tensors of rank 0's local
shapes under ``launch.op_analysis`` (a train step's round runs its
backward too). A sharding mismatch, a shape that does not split over its
axes or a model that refuses the mesh fails the case: the proof, with no
card, that the distribution config is coherent. Each case records
``trace_s`` (in place of ``lower_s``/``compile_s``), ``memory``,
``collectives`` and ``roofline`` (against ``h100_sxm`` unless
``REPRO_BACKEND`` names another), and the ops traced and kernel launches
charged.

Usage:
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape long_500k \\
        --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--algorithm", default="fedcams")
    ap.add_argument("--compressor", default="topk")
    ap.add_argument("--aggregation", default="dense")
    ap.add_argument("--ratio", type=float, default=1.0 / 64.0)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--delta-dtype", default="float32",
                    help="wire dtype for the dense client collective")
    ap.add_argument("--xlstm-chunkwise", type=int, default=0,
                    help="chunk size for chunkwise-recurrent mLSTM (0=off)")
    ap.add_argument("--moe-cf", type=float, default=0.0,
                    help="override MoE capacity factor (0=config default)")
    ap.add_argument("--tp-collective", default="psum",
                    choices=["psum", "rs_ag"])
    ap.add_argument("--shard-server-state", action="store_true")
    ap.add_argument("--overwrite", action="store_true",
                    help="recompute cases already present in --out")
    return ap


def build_configs(args):
    """The ``FedConfig`` and ``TrainConfig`` every train case of the run
    takes (the CLI's defaults: fedcams, top-k 1/64 over the dense uplink,
    K = 4, remat ``"full"``)."""
    from repro_torch.configs.base import FedConfig, TrainConfig
    fed = FedConfig(algorithm=args.algorithm, compressor=args.compressor,
                    compress_ratio=args.ratio, aggregation=args.aggregation,
                    local_steps=args.local_steps,
                    delta_dtype=args.delta_dtype,
                    shard_server_state=args.shard_server_state)
    train = TrainConfig(remat_policy=args.remat,
                        tp_collective=args.tp_collective)
    return fed, train


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.launch.mesh import (make_production_mesh,
                                         start_fake_world)
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.roofline import (model_flops_for,
                                             roofline_from_cost)
    from repro_torch.launch.steps import build_step, shape_allowed

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    fed, train = build_configs(args)

    def apply_variants(spec):
        cfg = spec.model
        if args.xlstm_chunkwise and cfg.xlstm is not None:
            cfg = dataclasses.replace(
                cfg, xlstm=dataclasses.replace(
                    cfg.xlstm, chunkwise=True,
                    chunk_size=args.xlstm_chunkwise))
        if args.moe_cf and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe,
                                             capacity_factor=args.moe_cf))
        if cfg is not spec.model:
            spec = dataclasses.replace(spec, model=cfg)
        return spec

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        chips = 512 if multi else 256
        mesh = None
        for arch in archs:
            spec = apply_variants(get_arch(arch))
            for shape_name in shapes:
                shape = INPUT_SHAPES[shape_name]
                key = f"{args.tag}/{mesh_name}/{arch}/{shape_name}"
                cached = results.get(key, {})
                if cached.get("status") in ("ok", "skipped") and \
                        not args.overwrite:
                    print(f"[skip-cached] {key}")
                    continue
                ok, why = shape_allowed(spec, shape)
                if not ok:
                    results[key] = {"status": "skipped", "reason": why}
                    print(f"[skip] {key}: {why}")
                    _flush(args.out, results)
                    continue
                if mesh is None:
                    start_fake_world(chips)
                    mesh = make_production_mesh(multi_pod=multi,
                                                device="cpu")
                t0 = time.time()
                try:
                    bundle = build_step(spec, shape, mesh, fed, train,
                                        chunk=args.chunk)
                    cost = analyze(bundle.fn, *bundle.abstract_args)
                    t_trace = time.time() - t0
                    if shape.kind == "train":
                        tokens = shape.global_batch * shape.seq_len
                        mf = model_flops_for(bundle.model.cfg, "train",
                                             tokens, fed.local_steps)
                    elif shape.kind == "prefill":
                        mf = model_flops_for(bundle.model.cfg, "prefill",
                                             shape.global_batch
                                             * shape.seq_len)
                    else:
                        mf = model_flops_for(bundle.model.cfg, "decode",
                                             shape.global_batch)
                    rl = roofline_from_cost(cost, chips=chips,
                                            model_flops=mf)
                    results[key] = {
                        "status": "ok",
                        "description": bundle.description,
                        "trace_s": round(t_trace, 1),
                        "memory": cost.memory,
                        "collectives": {
                            "bytes_by_kind": cost.coll_bytes,
                            "count_by_kind": cost.coll_count,
                        },
                        "ops": cost.ops,
                        "kernel_launches": {
                            "count_by_name": cost.launch_count,
                            "bytes_by_name": cost.launch_bytes,
                        },
                        "roofline": rl.to_dict(),
                    }
                    print(f"[ok] {key}: compute={rl.compute_s:.3e}s "
                          f"memory={rl.memory_s:.3e}s "
                          f"collective={rl.collective_s:.3e}s "
                          f"dominant={rl.dominant} "
                          f"useful={rl.useful_ratio:.2f} "
                          f"(trace {t_trace:.1f}s, {cost.ops} ops)")
                except Exception as e:
                    results[key] = {"status": "error",
                                    "error": str(e)[-2000:],
                                    "traceback":
                                        traceback.format_exc()[-4000:]}
                    print(f"[ERROR] {key}: {e}")
                _flush(args.out, results)


def _flush(path, results):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
