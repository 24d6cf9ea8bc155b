"""Training driver: federated LM training on the port's mesh.

Counterpart of ``repro.launch.train``, with the same CLI and output lines
(``--devices``, the JAX forced host device count, has no counterpart) and
``--device`` (default ``cuda``). The round is the port's mesh round
(``core.mesh.build_fed_round`` with a ``kernels.ops.KernelImpl``: on CUDA
the selection and the fused ingest launch their kernels, on the CPU the
plain paths run, as ``"auto"`` resolves them) over ``FederatedLMData``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --dp 2 --rounds 3 --aggregation sparse --device cpu

:func:`main` starts the ``--dp``·``--tp`` ranks itself (:func:`launch`):
gloo on the CPU with ``--device cpu``; on CUDA, NCCL with one rank a card
when there are cards enough, else gloo with the ranks sharing the cards
(NCCL refuses two ranks on one card). The mesh is the reference's: (dp,
tp) over ("data", "model"), each client's tp ranks holding its model
shards. :func:`train` is one rank's body, for a ``ModelConfig``; it needs
the process group. ``--deadline-s`` and ``--async-buffer`` are refused
with the reference's messages.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

#: the ``torch.profiler`` range around each round (each staged chunk), the
#: device synchronized at both ends (``scripts/profile_round.py o``)
ROUND_RANGE = "train.round"


def _mesh_layout(fed, dp: int, tp: int):
    """The reference's mesh: (dp, tp) over ("data", "model"), or (groups,
    dp/groups, tp) over ("cgroup", "data", "model") with two-level
    aggregation."""
    if fed.agg_groups > 1:
        return ((fed.agg_groups, dp // fed.agg_groups, tp),
                ("cgroup", "data", "model"))
    return (dp, tp), ("data", "model")


def train(cfg, fed, train_cfg, *, tp: int = 1, device=None,
          checkpoint: str = "", log_every: int = 1, scan_rounds: int = 0,
          keep_params: bool = False, log=print) -> dict:
    """One rank of the training driver on ``cfg`` (a ``ModelConfig``):
    the mesh over the initialized process group, params from
    ``torch.Generator().manual_seed(train_cfg.seed)`` on ``device`` (None:
    CUDA), ``train_cfg.rounds`` rounds of ``FederatedLMData``
    (``scan_rounds`` > 1: that many staged rounds a call through
    ``core.mesh.build_fed_rounds_scan``: on CUDA + NCCL one captured
    round replayed, on gloo the staged body run eagerly), then with
    ``checkpoint`` the global state written by rank 0 in the JAX package's
    layout. Rank 0 prints the reference's lines. Returns the rounds'
    metrics, each with its host time ``round_s`` (the device synchronized;
    a staged chunk's whole call, shared by its rounds) and its ``event_ms``
    by CUDA events (a staged round's: its graph replay's on NCCL; None on
    the CPU), the
    parameter count (this rank's: its model shards) and this rank's peak
    device memory (CUDA); with ``keep_params``, the final params gathered
    over the model axis, on the host (every rank calls the gather; rank 0
    returns them)."""
    from repro_torch import resolve_device
    from repro_torch.core import mesh as meshmod
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.kernels.ops import KernelImpl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import ParallelContext

    dev = resolve_device(device)
    model = Model(cfg, tp=tp)
    dp = dist.get_world_size() // tp
    shape, axes = _mesh_layout(fed, dp, tp)
    mesh = make_mesh(shape, axes, dev.type)
    ctx = ParallelContext(model_axis="model" if tp > 1 else None, tp=tp,
                          client_axes=fed.client_axes,
                          num_clients=fed.num_clients,
                          tp_collective=train_cfg.tp_collective, mesh=mesh)
    rnd = meshmod.build_fed_round(model, fed, train_cfg, ctx,
                                  kernel_impl=KernelImpl(device=dev))
    state = meshmod.init_fed_state(
        model, fed, torch.Generator().manual_seed(train_cfg.seed), ctx, dev)
    nparams = sum(t.numel() for t in tree_leaves(state.params))
    log = log if dist.get_rank() == 0 else None
    if log:
        log(f"arch={cfg.name} params={nparams/1e6:.1f}M "
            f"clients={fed.num_clients} algo={fed.algorithm}/"
            f"{fed.compressor} mesh={dp}x{tp}")
    data = FederatedLMData(num_clients=max(fed.num_clients, 1),
                           vocab_size=cfg.vocab_size, seed=train_cfg.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    t0 = time.time()

    def record(met, r, secs, **extra):
        rec = {k: float(v) for k, v in met.items()}
        rec.update(round=r, round_s=secs, **extra)
        history.append(rec)
        if log and (r % log_every == 0 or r == train_cfg.rounds - 1):
            extra = ""
            if "survivors" in rec:
                extra = (f"surv {rec['survivors']:3.0f}  "
                         f"rej {rec['rejected']:3.0f}  ")
            log(f"round {r:4d}  loss {rec['loss']:8.4f}  "
                f"{extra}({time.time() - t0:.1f}s)")

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    if scan_rounds and scan_rounds > 1:
        step = meshmod.build_fed_rounds_scan(rnd, log)
        r = 0
        while r < train_cfg.rounds:
            chunk = min(scan_rounds, train_cfg.rounds - r)
            raw, seeds = meshmod.stage_mesh_rounds(
                data, r, chunk, fed.local_steps, train_cfg.global_batch,
                train_cfg.seq_len)
            batch = meshmod.shard_batch(raw, model, fed, train_cfg, ctx, dev,
                                        staged=True)
            with torch.profiler.record_function(ROUND_RANGE):
                ts = synced()
                state, stacked = step(state, batch, seeds)
                secs = (synced() - ts) / chunk
            # each round's ms by CUDA events (its graph replay on NCCL, the
            # staged body on gloo), beside the whole call's share
            ev = step.round_ms() or [None] * chunk
            for i in range(chunk):
                record({k: v[i] for k, v in stacked.items()}, r + i, secs,
                       event_ms=ev[i])
            r += chunk
    else:
        for r in range(train_cfg.rounds):
            raw = data.mesh_batch(r, fed.local_steps, train_cfg.global_batch,
                                  train_cfg.seq_len)
            batch = meshmod.shard_batch(raw, model, fed, train_cfg, ctx, dev)
            timed = dev.type == "cuda"
            if timed:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with torch.profiler.record_function(ROUND_RANGE):
                ts = synced()
                if timed:
                    e0.record()
                state, met = rnd(state, batch, r)
                if timed:
                    e1.record()
                secs = synced() - ts
            record(met, r, secs,
                   event_ms=e0.elapsed_time(e1) if timed else None)
    out = {"history": history, "params": nparams,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None),
           "finite": all(bool(torch.isfinite(t).all()) for part in (
               state.params, state.m, state.v, state.vhat, state.errors)
               for t in tree_leaves(part))}
    if keep_params:
        from repro_torch.models.params import gather_params, tree_map
        full = gather_params(state.params, model.defs(), ctx)
        out["params"] = (tree_map(lambda t: t.detach().cpu(), full)
                         if dist.get_rank() == 0 else None)
        del full
    if checkpoint:
        from repro_torch.checkpoint import save_pytree
        from repro_torch.convert import mesh_state_to_jax
        full = meshmod.gather_fed_state(state, model, fed, ctx)
        if dist.get_rank() == 0:
            save_pytree(checkpoint, mesh_state_to_jax(full),
                        {"arch": cfg.name, "rounds": train_cfg.rounds})
            log(f"checkpoint -> {checkpoint}")
        dist.barrier()
    return out


def launch(cfg, fed, train_cfg, *, dp: int, tp: int = 1, device="cuda",
           timeout: float = 3600, **kw) -> dict:
    """:func:`train` on ``dp·tp`` spawned ranks (``launch.mesh.spawn``):
    gloo on the CPU (``device="cpu"``); on CUDA NCCL when every rank has a
    card of its own, else gloo with the ranks sharing the cards. Returns
    rank 0's result; a rank that fails, or outlives ``timeout`` seconds,
    raises (the others are stopped)."""
    from repro_torch.launch.mesh import spawn
    return spawn(train, dp * tp, cfg, fed, train_cfg, device=device,
                 timeout=timeout, tp=tp, **kw)


def build_fed(args, ap):
    """The reference's ``FedConfig`` (and its refusals) from the CLI."""
    from repro_torch.configs import FedConfig

    if args.agg_groups > 1:
        if args.dp % args.agg_groups:
            ap.error(f"--dp {args.dp} not divisible by "
                     f"--agg-groups {args.agg_groups}")
        client_axes = ("cgroup", "data")
    else:
        client_axes = ("data",) if args.dp > 1 else ()
    if args.deadline_s > 0:
        ap.error("--deadline-s is FedSim wire-mode only — the mesh driver "
                 "has no transport clock to cut against; use --crash-prob "
                 "to model dropouts here")
    if args.async_buffer > 0:
        ap.error("--async-buffer is FedSim wire-mode only — the event-"
                 "driven buffered engine needs the simulated transport "
                 "clock's per-client delivery times, which the mesh "
                 "driver does not model")
    fault = None
    if args.crash_prob > 0 or args.corrupt_prob > 0 \
            or args.max_update_norm > 0:
        from repro_torch.comm.faults import FaultConfig
        fault = FaultConfig(crash_prob=args.crash_prob,
                            corrupt_prob=args.corrupt_prob,
                            corrupt_mode=args.corrupt_mode,
                            max_update_norm=args.max_update_norm,
                            seed=args.fault_seed)
    return FedConfig(algorithm=args.algorithm, compressor=args.compressor,
                     compress_ratio=args.ratio, aggregation=args.aggregation,
                     agg_groups=args.agg_groups,
                     mesh_sparse_impl=args.mesh_sparse_impl,
                     fused_ingest=args.fused_ingest,
                     server_state_dtype=args.server_state_dtype,
                     local_steps=args.local_steps, num_clients=args.dp,
                     local_opt=args.local_opt,
                     local_momentum=args.local_momentum,
                     prox_mu=args.prox_mu, eta_l_decay=args.eta_l_decay,
                     local_steps_min=args.local_steps_min,
                     participating=args.participating, eta=args.eta,
                     eta_l=args.eta_l, client_axes=client_axes,
                     # the γ diagnostic consumes the full-cohort dense
                     # mean, which a partial (fault-tolerant) round never
                     # computes
                     track_gamma=fault is None, fault=fault)


def parser() -> argparse.ArgumentParser:
    """The reference's CLI, with ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--algorithm", default="fedcams")
    ap.add_argument("--compressor", default="topk")
    ap.add_argument("--ratio", type=float, default=1.0 / 64.0)
    ap.add_argument("--aggregation", default="dense")
    ap.add_argument("--agg-groups", type=int, default=1,
                    help="two-level hierarchical sparse aggregation: split "
                         "the --dp clients into this many edge groups; "
                         "each group merges its members' (vals, idx) "
                         "selections into one dense partial and only the g "
                         "partials reach the root (dp %% groups == 0)")
    ap.add_argument("--mesh-sparse-impl", default="auto",
                    choices=("auto", "kernel", "jnp"),
                    help="sparse-aggregation selection provider: the "
                         "topk_ef_sparse kernel or the plain "
                         "Compressor.select path; auto = the kernel on "
                         "CUDA, the plain path on the CPU")
    ap.add_argument("--fused-ingest", default="auto",
                    choices=("auto", "kernel", "jnp", "off"),
                    help="one-pass fused server ingest (scatter-mean + "
                         "FedAMS update in one pass over the state); auto = "
                         "fuse where the round is eligible, the kernel on "
                         "CUDA")
    ap.add_argument("--server-state-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"),
                    help="server second-moment (v, v̂) storage dtype "
                         "(int8-blockscale is FedSim-only)")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-opt", default="sgd",
                    choices=("sgd", "sgdm", "prox"))
    ap.add_argument("--local-momentum", type=float, default=0.9)
    ap.add_argument("--prox-mu", type=float, default=0.01)
    ap.add_argument("--eta-l-decay", type=float, default=1.0)
    ap.add_argument("--local-steps-min", type=int, default=0)
    ap.add_argument("--participating", type=int, default=0)
    ap.add_argument("--crash-prob", type=float, default=0.0)
    ap.add_argument("--corrupt-prob", type=float, default=0.0)
    ap.add_argument("--corrupt-mode", default="nan",
                    choices=("nan", "inf", "bitflip", "truncate"))
    ap.add_argument("--max-update-norm", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="FedSim wire-mode only; the mesh driver rejects it")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="FedSim wire-mode only; the mesh driver rejects it")
    ap.add_argument("--staleness-weight", default="inv_sqrt",
                    choices=("inv_sqrt", "uniform", "inv_linear", "exp"))
    ap.add_argument("--eta", type=float, default=0.5)
    ap.add_argument("--eta-l", type=float, default=0.05)
    ap.add_argument("--use-kernels", action="store_true",
                    help="accepted for the reference's CLI: the port hands "
                         "the round a KernelImpl on every device")
    ap.add_argument("--scan-rounds", type=int, default=0,
                    help="stage this many rounds per call (0/1 = one call "
                         "a round)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig
    from repro_torch.configs.registry import get_arch

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    fed = build_fed(args, ap)
    train_cfg = TrainConfig(global_batch=args.global_batch,
                            seq_len=args.seq_len, rounds=args.rounds,
                            remat_policy="none")
    launch(cfg, fed, train_cfg, dp=args.dp, tp=args.tp, device=args.device,
           checkpoint=args.checkpoint, log_every=args.log_every,
           scan_rounds=args.scan_rounds)


if __name__ == "__main__":
    main()
