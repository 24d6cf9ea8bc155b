"""Route z's train step held against its memory reckoning on the card: what
the caching allocator holds at its peak, what ``launch/op_analysis``
records on the card's tensors, and what it reckons on ``meta`` (ROADMAP
Queue 3 item 35).

    python3 -u scripts/step_memory.py [--batch 16] [--seq 512]

Needs a card. The step is ``chip_smoke.py``'s ``_z_counts`` one:
xlstm-350m at ``Z_LAYERS`` layers (its published widths, bf16 compute),
``Model.loss`` under remat ``"full"`` and the gradient of every param, at
batch x seq tokens from a seeded generator. After a warm-up call:

1. the plain step (no recorder) under ``torch.cuda.memory.
   _record_memory_history``: the allocator's peak above what was allocated
   before, and its live blocks at the peak, replayed from the history's
   alloc / free events (largest first, by size);
2. the same step inside an ``OpCost`` on the card: the allocator's peak in
   that run, and the recorder's live set at its own peak by op and shape,
   with and without the in-place rule (an out-of-place twin's output
   takes over an operand a plain run writes into);
3. ``analyze`` of the step on meta copies, with and without that rule.

Prints each beside the card's name and power limit, names the storages the
recorded run holds at its peak that the plain run's peak does not, and
writes ``chiprun_out/step_memory.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def recorder(inplace: bool = True):
    """An ``OpCost`` that names each storage (the op that made it, shape,
    dtype) and replays its live set at the peak; ``inplace=False`` keeps
    every out-of-place twin's output as its own storage."""
    import torch

    from repro_torch.launch import op_analysis as oa

    class Named(oa.OpCost):
        def __init__(self, **kw):
            super().__init__(**kw)
            # a storage's key is its address, reused once it is freed:
            # each storage made gets an id of its own
            self.names, self.ids, self.keys, self.alias = [], {}, [], {}
            self._op = "argument"

        def _hold(self, t):
            key = super()._hold(t)
            if key is not None:
                self.ids[key] = len(self.names)
                self.names.append((self._op, tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")))
                self.keys.append(self.ids[key])
            return key

        def _free(self, key):
            n = len(self.events)
            super()._free(key)
            if len(self.events) > n:
                self.keys.append(self.ids[key])

        def _settle(self):
            p = self._pending
            if p is not None and p[1] not in self.ids:
                p = None
            if not inplace:
                self._pending = None
                return
            super()._settle()
            if p is not None and self.events[p[0]][0] == 0:
                self.alias[self.keys[p[0]]] = self.ids[p[1]]

        def close(self, out):
            self._settle()
            self.raw = [e[0] for e in self.events]
            return super().close(out)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._op = func.overloadpacket.__name__
            return super().__torch_dispatch__(func, types, args, kwargs)

        def live_at_peak(self) -> list:
            """(bytes, op, shape, dtype) of each storage live at the
            peak of the recorded curve, largest first."""
            live, best, run, peak = {}, {}, 0, 0
            for key, d in zip(self.keys, self.raw):
                if d > 0:
                    live[key] = d
                elif d < 0:
                    while key not in live and key in self.alias:
                        key = self.alias[key]   # the storage it wrote into
                    live.pop(key, None)
                run += d
                if run > peak:
                    peak, best = run, dict(live)
            return sorted(((n, *self.names[k]) for k, n in best.items()),
                          key=lambda r: -r[0])

    return Named()


def z_step(batch: int, seq: int, device):
    """Route z's model, params on ``device`` (seed 7), tokens (seed 8), and
    the loss + gradient function."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import ParallelContext
    model, ctx = Model(cs.z_cfg()), ParallelContext()
    params = model.init(torch.Generator(device=device).manual_seed(7),
                        device)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, size=(batch, seq + 1)).astype(
            np.int32)).to(device)
    b = {"tokens": tok[:, :-1].contiguous(),
         "labels": tok[:, 1:].contiguous()}

    def grad(p, bb):
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        loss, _ = model.loss(p, bb, ctx, remat_policy="full")
        return torch.autograd.grad(loss, leaves)

    return grad, params, b


def recorded(fn, args, inplace: bool = True):
    """``fn(*args)`` inside a :func:`recorder`: (the recorder, its memory
    record)."""
    rec = recorder(inplace)
    with rec:
        rec.add_arguments(args)
        rec.close(fn(*args))
    return rec, rec.cost.memory


def allocator_peak(history: dict) -> tuple:
    """The peak of live bytes replayed from a memory history's events, and
    the blocks live there: (bytes, the innermost frame in this repo)."""
    live, best, run, peak = {}, {}, 0, 0
    freed = {"free_completed"} if any(
        e["action"] == "free_completed" for e in history) else {
        "free_requested"}
    for e in history:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            run += e["size"]
        elif e["action"] in freed and e["addr"] in live:
            run -= live.pop(e["addr"])["size"]
        else:
            continue
        if run > peak:
            peak, best = run, dict(live)

    def site(e):
        for f in e.get("frames", ()):
            if "repro_torch" in f["filename"] or "scripts" in f["filename"]:
                return f"{Path(f['filename']).name}:{f['line']}:{f['name']}"
        return "?"

    return peak, sorted(((e["size"], site(e)) for e in best.values()),
                        key=lambda r: -r[0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # puts ROOT/src first

    import torch

    from repro_torch.launch import op_analysis as oa

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a card")
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    fn, params, batch = z_step(args.batch, args.seq, "cuda")
    arg_bytes = sum(t.untyped_storage().nbytes()
                    for t in oa._tensors((params, batch)))
    fn(params, batch)
    cs._sync()
    # 1. the plain step
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000)
    fn(params, batch)
    cs._sync()
    hist = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    plain_peak = torch.cuda.max_memory_allocated() - base
    replay_peak, blocks = allocator_peak(hist)
    # 2. inside a recorder on the card
    torch.cuda.reset_peak_memory_stats()
    on_card, card_mem = recorded(fn, (params, batch))
    mode_peak = torch.cuda.max_memory_allocated() - base
    _, card_raw = recorded(fn, (params, batch), inplace=False)
    cs._sync()
    # 3. meta
    margs = cs._on_meta((params, batch))
    meta = oa.analyze(fn, *margs)
    raw_rec, meta_raw = recorded(fn, margs, inplace=False)
    meta_rec, _ = recorded(fn, margs)
    held_card, held_meta = on_card.live_at_peak(), meta_rec.live_at_peak()
    held_raw = raw_rec.live_at_peak()
    extra = collections.Counter(r[1:] for r in held_raw)
    extra.subtract(collections.Counter(r[1:] for r in held_meta))
    extra = {f"{op} {list(shape)} {dt}": n for (op, shape, dt), n
             in extra.items() if n > 0}
    gb = 1e9
    res = {
        "card": card, "batch": args.batch, "seq": args.seq,
        "argument_bytes": arg_bytes,
        "plain_peak_temp": plain_peak, "plain_replay_peak_temp": replay_peak,
        "recorded_run_allocator_peak_temp": mode_peak,
        "opcost_card": card_mem, "opcost_card_without_inplace": card_raw,
        "meta": meta.memory, "meta_without_inplace": meta_raw,
        "plain_blocks_at_peak": blocks[:12],
        "opcost_card_at_peak": held_card[:12],
        "opcost_meta_at_peak": held_meta[:12],
        "meta_without_inplace_at_peak": held_raw[:12],
        "held_without_inplace_only": extra,
        "card_equals_meta_at_peak": held_card == held_meta,
        "plain_over_meta": (arg_bytes + plain_peak) / (
            meta.memory["argument_size"] + meta.memory["temp_size"]),
    }
    print(f"[{card}] xlstm-350m, {cs.Z_LAYERS} layers, loss + gradient, "
          f"remat full, batch {args.batch} x {args.seq}: arguments "
          f"{arg_bytes / gb:.4f} GB; plain step's peak above them "
          f"{plain_peak / gb:.4f} GB (replayed from the allocator history "
          f"{replay_peak / gb:.4f}); the step inside OpCost: the allocator's "
          f"peak {mode_peak / gb:.4f}, the record's temp "
          f"{card_mem['temp_size'] / gb:.4f} ({card_raw['temp_size'] / gb:.4f}"
          f" without the in-place rule); meta's temp "
          f"{meta.memory['temp_size'] / gb:.4f} "
          f"({meta_raw['temp_size'] / gb:.4f} without it); card's "
          f"(arguments + plain peak) over meta's (arguments + temp) "
          f"{res['plain_over_meta']:.4f}")
    print(f"[{card}] the plain step's live blocks at its peak (bytes, "
          f"site): {blocks[:8]}")
    print(f"[{card}] OpCost's live storages at its peak, on the card "
          f"(= meta's: {res['card_equals_meta_at_peak']}): {held_card[:8]}")
    print(f"[{card}] held at the peak without the in-place rule and not "
          f"with it (meta): {extra}")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "step_memory.json").write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
