"""Serve a small model with batched requests on the PyTorch port: the same
run as serve_batched.py — prefill a batch of prompts, then greedy-decode
continuations through the KV-cache path — with ``repro_torch`` at tp = 1
on the card (or the CPU with ``--device cpu``). Any smoke config the port
builds serves, the MoE one included. As serve_batched.py jits its prefill
and decode step, both run as the programs of one
``repro_torch.launch.programs.Session``: on the card one CUDA graph each,
captured at the first prefill (its time included) and replayed, the
position on the device; on the CPU the same bodies, run eagerly.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch gemma2-2b \\
        [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.programs import programs_of  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding.rules import ParallelContext  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="gemma2-2b",
                help="architecture id (smoke variant is served)")
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--prompt-len", type=int, default=32)
ap.add_argument("--gen", type=int, default=32)
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()

spec = get_arch(args.arch)
cfg = spec.smoke
if cfg.is_encoder:
    raise SystemExit(f"{args.arch} is encoder-only (no decode)")
dev = resolve_device(args.device)
max_len = args.prompt_len + args.gen
model = Model(cfg, tp=1)
ctx = ParallelContext()
params = model.init(torch.Generator().manual_seed(0), dev)

prompts = np.random.default_rng(0).integers(
    0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)


def synced():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time()


sess = programs_of(model).session(model, params, ctx, batch=args.batch,
                                  prompt=args.prompt_len, max_len=max_len,
                                  chunk=2048)
t0 = synced()
sess.prefill(model, params, torch.as_tensor(prompts, device=dev))
tok = sess.carry.token           # the next step's input, on the device
print(f"prefill {args.batch}x{args.prompt_len}: "
      f"{(synced()-t0)*1e3:.0f} ms")

out = [tok[:, 0].to("cpu", copy=True).numpy()]
t0 = synced()
for i in range(args.gen - 1):
    sess.decode(model, params)
    out.append(tok[:, 0].to("cpu", copy=True).numpy())
dt = synced() - t0
gen = np.stack(out, 1)
print(f"decode: {dt/max(args.gen-1, 1)*1e3:.1f} ms/step, "
      f"{args.batch*(args.gen-1)/max(dt, 1e-9):.0f} tok/s")
for b in range(min(args.batch, 3)):
    print(f"  request[{b}]: ...{prompts[b,-4:].tolist()} -> "
          f"{gen[b,:12].tolist()}...")
