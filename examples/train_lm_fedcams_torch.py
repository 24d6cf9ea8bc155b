"""End-to-end driver: federated training of a transformer LM with FedCAMS,
on the PyTorch port.

The twin of ``examples/train_lm_fedcams.py``, with the same flags and
lines, and ``--device`` (default ``cuda``). It runs the port's production
path (``repro_torch.models.Model`` and the mesh round of
``repro_torch.core.mesh``) on ``clients × tp`` ranks it starts itself
(``repro_torch.launch.mesh.spawn``: gloo on the CPU; on CUDA, NCCL with a
card a rank, else gloo with the ranks sharing the cards). The default
preset is a ~10M-param gemma-2-style model federated over 4 clients with
2-way tensor parallelism; ``--preset 100m`` scales the same config up.

    PYTHONPATH=src python examples/train_lm_fedcams_torch.py --rounds 200 \\
        --device cpu
    PYTHONPATH=src python examples/train_lm_fedcams_torch.py --preset 100m \\
        --rounds 300
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

SIZES = {  # layers, d_model, heads, kv, d_ff, vocab
    "2m": (2, 128, 4, 2, 384, 512),
    "10m": (4, 256, 8, 4, 768, 2048),
    "100m": (12, 768, 12, 4, 2048, 8192),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=["2m", "10m", "100m"])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--compressor", default="topk")
    ap.add_argument("--ratio", type=float, default=1 / 64)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def rank_main(args, *, device):
    """One rank: the model at ``args.tp``, the (clients, tp) mesh over
    ("data", "model"), the round, ``args.rounds`` rounds; rank 0 prints
    the reference's lines and writes the checkpoint (the global params)."""
    import torch.distributed as dist

    from repro_torch.configs import FedConfig, ModelConfig, TrainConfig
    from repro_torch.core import mesh as meshmod
    from repro_torch.data.synthetic import FederatedLMData
    from repro_torch.kernels.ops import KernelImpl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import gather_params, tree_leaves
    from repro_torch.sharding.rules import ParallelContext

    import torch
    L, D, H, KV, FF, V = SIZES[args.preset]
    cfg = ModelConfig(name=f"lm-{args.preset}", family="dense", num_layers=L,
                      d_model=D, num_heads=H, num_kv_heads=KV, d_ff=FF,
                      vocab_size=V, attn_pattern=(64, 0), logit_softcap=30.0,
                      dtype="float32")
    fed = FedConfig(algorithm="fedcams", compressor=args.compressor,
                    compress_ratio=args.ratio, num_clients=args.clients,
                    local_steps=2, eta=0.3, eta_l=0.05, client_axes=("data",))
    train = TrainConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                        remat_policy="none")
    dev = torch.device(device)
    mesh = make_mesh((args.clients, args.tp), ("data", "model"), dev.type)
    model = Model(cfg, tp=args.tp)
    ctx = ParallelContext(model_axis="model" if args.tp > 1 else None,
                          tp=args.tp, client_axes=("data",),
                          num_clients=args.clients, mesh=mesh)
    step = meshmod.build_fed_round(model, fed, train, ctx,
                                   kernel_impl=KernelImpl(device=dev))
    state = meshmod.init_fed_state(model, fed, torch.Generator().manual_seed(0),
                                   ctx, dev)
    log = print if dist.get_rank() == 0 else (lambda *_: None)
    nparams = sum(t.numel() for t in tree_leaves(state.params))
    log(f"model={cfg.name} params={nparams/1e6:.1f}M clients={args.clients} "
        f"tp={args.tp} compressor={fed.compressor} r={fed.compress_ratio:g}")
    data = FederatedLMData(num_clients=args.clients, vocab_size=V)
    t0 = time.time()
    losses = []
    for r in range(args.rounds):
        raw = data.mesh_batch(r, fed.local_steps, args.global_batch,
                              args.seq_len)
        batch = meshmod.shard_batch(raw, model, fed, train, ctx, dev)
        state, met = step(state, batch, r)
        losses.append(float(met["loss"]))
        if r % 10 == 0 or r == args.rounds - 1:
            log(f"round {r:4d}  loss {losses[-1]:7.4f}  "
                f"wire {float(met['wire_up_bytes'])/1e6:6.2f} MB/round  "
                f"({time.time()-t0:6.1f}s)")
    if args.checkpoint:
        from repro_torch.checkpoint import save_pytree
        from repro_torch.convert import model_params_to_jax
        full = gather_params(state.params, model.defs(), ctx)
        if dist.get_rank() == 0:
            save_pytree(args.checkpoint, model_params_to_jax(full),
                        {"preset": args.preset, "rounds": args.rounds})
            log("saved", args.checkpoint)
        dist.barrier()
    return losses


def main(argv=None):
    from repro_torch.launch.mesh import spawn
    args = parser().parse_args(argv)
    return spawn(rank_main, args.clients * args.tp, args, device=args.device)


if __name__ == "__main__":
    main()
