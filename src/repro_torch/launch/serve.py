"""Serving driver: prefill a batch of prompts, then greedy-decode.

Counterpart of ``repro.launch.serve``, with the same CLI and output lines
(``--devices``, the JAX forced host device count, has no counterpart) and
``--device`` (default ``cuda``; ``cpu`` runs the smoke configs anywhere):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --batch 4 --prompt-len 16 --gen 16 --device cpu

:func:`serve` is the body, for a ``ModelConfig``: random weights from a
seeded ``torch.Generator`` (or ``--checkpoint``, a params tree in the JAX
package's files, through ``checkpoint.load_pytree``), the reference's
prompts (``np.random.default_rng(0)``), then :func:`generate`. At
``--tp > 1`` it starts tp ranks (``launch.mesh.spawn``: gloo on the CPU;
on CUDA gloo with the ranks sharing the card, or NCCL with a card a rank),
each holding its model shards of the same global weights over a
``("model",)`` mesh, and rank 0 prints the tokens, as the reference's
model-axis mesh does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompts, gen: int, *, max_len: int = 0,
             chunk: int = 2048, log=print, ctx=None) -> dict:
    """Prefill ``prompts`` ((B, S) int32 numpy) and greedy-decode ``gen``
    tokens with ``model`` on ``params``' device, printing the reference's
    lines (``log`` None: silent). Returns the generated tokens ((B, gen)
    numpy), the prefill's last-position logits (B, V) on the host
    (gathered over the model axis), the prefill and decode times (host
    clock, the device synchronized) and whether every logit was finite.
    ``ctx``: this rank's context over a model axis (None: one process).
    The prefill (with the first token) and the decode loop run in
    ``serve.prefill`` / ``serve.decode`` profiler ranges
    (``scripts/profile_round.py n``). ``chunk`` is ``Model.prefill``'s
    q-chunk (the reference's default 2048; a prompt longer than 2·chunk
    must be a multiple of it)."""
    from repro_torch.models.model import greedy_sample
    from repro_torch.sharding.rules import ParallelContext

    cfg = model.cfg
    B, S = prompts.shape
    max_len = max_len or (S + gen)
    ctx = ctx or ParallelContext()
    log = log or (lambda *_: None)
    dev = params["final_norm"].device
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def seen(lg):
        nonlocal finite
        finite = finite & torch.isfinite(lg).all()

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function("serve.prefill"):
            logits, caches = model.prefill(
                params, torch.as_tensor(prompts, device=dev), ctx,
                max_len=max_len, chunk=chunk)
            seen(logits)
            tok = greedy_sample(logits, ctx)[:, None]
            out = [tok[:, 0].cpu().numpy()]
        t_prefill = time.perf_counter() - t0
        logits0 = ctx.all_gather_model(logits, axis=-1).cpu()

        t0 = time.perf_counter()
        with torch.profiler.record_function("serve.decode"):
            for i in range(gen - 1):
                logits, caches = model.decode_step(params, tok, caches, S + i,
                                                   ctx, max_len=max_len)
                seen(logits)
                tok = greedy_sample(logits, ctx)[:, None]
                out.append(tok[:, 0].cpu().numpy())
        t_dec = time.perf_counter() - t0
    tokens = np.stack(out, 1)
    log(f"arch={cfg.name} batch={B} prompt={S} gen={gen}")
    log(f"prefill: {t_prefill*1e3:.1f} ms   decode: "
        f"{t_dec/max(gen-1,1)*1e3:.2f} ms/token  "
        f"({B*(gen-1)/max(t_dec,1e-9):.1f} tok/s)")
    for b in range(min(B, 4)):
        log(f"  seq[{b}]: {prompts[b, -4:].tolist()} -> {tokens[b].tolist()}")
    return {"tokens": tokens, "logits0": logits0, "prefill_s": t_prefill,
            "decode_s": t_dec, "finite": bool(finite)}


def model_context(tp: int, device):
    """One rank's context over a ``("model",)`` mesh of ``tp`` ranks (the
    process group initialized), the reference's serving mesh; tp = 1:
    the context of one process."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import ParallelContext

    if tp <= 1:
        return ParallelContext()
    return ParallelContext(model_axis="model", tp=tp, mesh=make_mesh(
        (tp,), ("model",), torch.device(device).type))


def serve(cfg, *, batch: int = 4, prompt_len: int = 16, gen: int = 16,
          max_len: int = 0, tp: int = 1, checkpoint: str = "", device=None,
          generator=None, log=print, ctx=None) -> dict:
    """The serving driver on ``cfg`` (a ``ModelConfig``): the model at
    ``tp``, params from ``generator`` (None: ``torch.Generator()
    .manual_seed(0)``, drawn on the host; a seeded CUDA generator draws on
    the card) on ``device`` (None: CUDA) or restored from ``checkpoint``,
    the reference's prompts, then :func:`generate`. Returns
    :func:`generate`'s result with the prompts, the params (another batch
    can be served on the same weights without drawing them again:
    qwen2-moe-a2.7b's are 57 GB) and the seconds the params took to draw
    or restore.

    At ``tp > 1`` without ``ctx`` it starts tp ranks running this body
    (each draws the global weights from a generator of the same device
    type and seed and keeps its shards) and returns rank 0's result,
    without the params. Inside a rank, ``ctx`` is that rank's context
    (:func:`model_context`); only rank 0 logs."""
    from repro_torch import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.models.params import shard_params

    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode serving")
    dev = resolve_device(device)
    if tp > 1 and ctx is None:
        from repro_torch.launch.mesh import spawn
        g = generator or torch.Generator().manual_seed(0)
        return spawn(_serve_rank, tp, cfg, g.device.type, g.initial_seed(),
                     device=dev.type, batch=batch, prompt_len=prompt_len,
                     gen=gen, max_len=max_len, tp=tp, checkpoint=checkpoint,
                     log=log)
    log = log or (lambda *_: None)
    model = Model(cfg, tp=tp)
    t0 = time.perf_counter()
    gen_ = generator or torch.Generator().manual_seed(0)
    if checkpoint:
        from repro_torch.checkpoint import load_pytree
        params, meta = load_pytree(checkpoint, model.init(gen_, dev))
        if ctx is not None and tp > 1:
            params = shard_params(params, model.defs(), ctx)
        log(f"restored {meta}")
    else:
        params = model.init(gen_, dev, ctx=ctx if tp > 1 else None)
    _sync(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(batch, prompt_len)).astype(np.int32)
    res = generate(model, params, prompts, gen, max_len=max_len, log=log,
                   ctx=ctx)
    res.update(prompts=prompts, params=params, init_s=init_s)
    return res


def _serve_rank(cfg, gen_device: str, seed: int, *, device, tp: int, log,
                **kw) -> dict:
    """One of :func:`serve`'s tp ranks: its context, then the body; rank 0
    logs and returns the result (the params stay with the rank)."""
    import torch.distributed as dist

    ctx = model_context(tp, device)
    generator = torch.Generator(
        device=device if gen_device == "cuda" else "cpu").manual_seed(seed)
    res = serve(cfg, tp=tp, device=device, generator=generator, ctx=ctx,
                log=log if dist.get_rank() == 0 else None, **kw)
    res.pop("params")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
          max_len=args.max_len, tp=args.tp, checkpoint=args.checkpoint,
          device=args.device)


if __name__ == "__main__":
    main()
