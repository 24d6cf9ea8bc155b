"""Serving driver: prefill a batch of prompts, then greedy-decode.

Counterpart of ``repro.launch.serve``, with the same CLI and output lines
(``--devices``, the JAX forced host device count, has no counterpart) and
``--device`` (default ``cuda``; ``cpu`` runs the smoke configs anywhere):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --batch 4 --prompt-len 16 --gen 16 --device cpu

:func:`serve` is the body, for a ``ModelConfig``: random weights from a
seeded ``torch.Generator`` (or ``--checkpoint``, a params tree in the JAX
package's files, through ``checkpoint.load_pytree``), the reference's
prompts (``np.random.default_rng(0)``), then :func:`generate`. The port
runs at tp = 1: ``--tp > 1`` raises ``NotImplementedError``.
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
             chunk: int = 2048, log=print) -> dict:
    """Prefill ``prompts`` ((B, S) int32 numpy) and greedy-decode ``gen``
    tokens with ``model`` on ``params``' device, printing the reference's
    lines. Returns the generated tokens ((B, gen) numpy), the prefill and
    decode times (host clock, the device synchronized) and whether every
    logit was finite. The prefill (with the first token)
    and the decode loop run in ``serve.prefill`` / ``serve.decode``
    profiler ranges (``scripts/profile_round.py n``). ``chunk`` is ``Model.prefill``'s
    q-chunk (the reference's default 2048; a prompt longer than 2·chunk
    must be a multiple of it)."""
    from repro_torch.models.model import greedy_sample
    from repro_torch.sharding.rules import ParallelContext

    cfg = model.cfg
    B, S = prompts.shape
    max_len = max_len or (S + gen)
    ctx = ParallelContext()
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
    return {"tokens": tokens, "prefill_s": t_prefill, "decode_s": t_dec,
            "finite": bool(finite)}


def serve(cfg, *, batch: int = 4, prompt_len: int = 16, gen: int = 16,
          max_len: int = 0, tp: int = 1, checkpoint: str = "", device=None,
          generator=None, log=print) -> dict:
    """The serving driver on ``cfg`` (a ``ModelConfig``): the model at
    ``tp``, params from ``generator`` (None: ``torch.Generator()
    .manual_seed(0)``, drawn on the host; a seeded CUDA generator draws on
    the card) on ``device`` (None: CUDA) or restored from ``checkpoint``,
    the reference's prompts, then :func:`generate`. Returns
    :func:`generate`'s result with the prompts, the params (another batch
    can be served on the same weights without drawing them again:
    qwen2-moe-a2.7b's are 57 GB) and the seconds the params took to draw
    or restore."""
    from repro_torch import resolve_device
    from repro_torch.models.model import Model

    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode serving")
    model = Model(cfg, tp=tp)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    params = model.init(generator or torch.Generator().manual_seed(0), dev)
    if checkpoint:
        from repro_torch.checkpoint import load_pytree
        params, meta = load_pytree(checkpoint, params)
        log(f"restored {meta}")
    _sync(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(batch, prompt_len)).astype(np.int32)
    res = generate(model, params, prompts, gen, max_len=max_len, log=log)
    res.update(prompts=prompts, params=params, init_s=init_s)
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
