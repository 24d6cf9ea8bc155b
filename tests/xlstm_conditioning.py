"""How well xlstm-350m's local round is conditioned, in the port and in the
JAX reference (ROADMAP Queue 3 item 29). CPU only; imports both packages.

    PYTHONPATH=src python tests/xlstm_conditioning.py [--layers 24] [--seq 128]

From one init drawn with numpy (the port's params converted from it),
xlstm-350m at its published widths (or its smoke config's), fp32,
``--layers`` layers, runs the local phase of a dense
FedAvg round for one client (K plain SGD steps at route w's η_l = 0.001,
batch 2 x ``--seq`` tokens a step, remat "none") for K = 1 and 2, three
ways: the reference (``jax.jit``), the port, and the reference again from
its init with every element of every leaf moved one ulp up. For
each K it prints the losses and, for the port and for the moved reference
against the reference, each leaf's max |difference| over its largest
|value| (route w's reading), worst first. In every run it records the side
the mLSTM's normalizer ``max(|η|, exp(-m))`` takes at each position, for
each local step and mLSTM layer (the reference through a ``jnp`` whose
``maximum`` calls back, the port through a dispatch mode), and prints how
many positions take the η side and how many differ from the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.registry import get_arch as jax_arch  # noqa: E402
from repro.models import params as jax_pdefs  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.sharding.rules import ParallelContext as JaxCtx  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import leaves_with_paths, tree_map  # noqa: E402
from repro_torch.sharding.rules import ParallelContext  # noqa: E402

ETA_L, BATCH = 0.001, 2


class _RecordingJnp:
    """``jax.numpy`` whose ``maximum`` of two 3-d arrays (the mLSTM's
    normalizer, (B, chunk, heads)) hands both operands to ``sink`` (read
    when the callback runs, so one trace serves every run)."""

    def __init__(self):
        self.sink = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def maximum(self, a, b):
        if getattr(a, "ndim", 0) == 3 and getattr(b, "ndim", 0) == 3:
            jax.debug.callback(
                lambda x, y: self.sink.append((np.asarray(x),
                                               np.asarray(y))), a, b)
        return jnp.maximum(a, b)


_JNP = _RecordingJnp()


class _RecordingMax(TorchDispatchMode):
    """Hands both operands of every 3-d ``aten.maximum`` to ``sink``."""

    def __init__(self, sink: list):
        super().__init__()
        self._sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.maximum.default and args[0].dim() == 3:
            self._sink.append(tuple(t.detach().numpy().copy()
                                    for t in args[:2]))
        return func(*args, **(kwargs or {}))


def setup(layers: int, seq: int, k_max: int = 2, seed: int = 3,
          widths: str = "model"):
    """The two models (xlstm-350m's ``widths``: "model", published, or
    "smoke"), the reference's init (and it with every element one ulp up)
    and ``k_max`` batches of tokens and labels."""
    jm = JaxModel(dataclasses.replace(getattr(jax_arch("xlstm-350m"), widths),
                                      num_layers=layers, dtype="float32"))
    tm = Model(dataclasses.replace(getattr(get_arch("xlstm-350m"), widths),
                                   num_layers=layers, dtype="float32"))
    # the JAX init keys its leaves by Python's salted hash(), a new draw
    # in every process: draw the params with numpy (the draw of
    # test_torch_lm_train's mesh rounds), the same in every run
    flat, td = jax.tree_util.tree_flatten(jm.defs(), is_leaf=jax_pdefs.is_def)
    jp = jax.tree_util.tree_unflatten(td, [
        (np.zeros if d.init == "zeros" else np.ones)(d.shape, d.dtype)
        if d.init in ("zeros", "ones") else
        (np.random.default_rng((0, i)).standard_normal(d.shape)
         * d.scale).astype(d.dtype) for i, d in enumerate(flat)])
    moved = jax.tree.map(
        lambda a: np.nextafter(np.asarray(a), np.float32(np.inf)), jp)
    rng = np.random.default_rng(seed)
    vocab = jm.cfg.vocab_size
    batches = [{k: rng.integers(0, vocab, (BATCH, seq)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(k_max)]
    return jm, tm, jp, moved, batches


def jax_local(grad, params, batches, sink: list):
    """K SGD steps of the reference; (the params, the losses), the
    normalizer's operands appended to ``sink`` step by step."""
    _JNP.sink = sink
    losses = []
    for b in batches:
        loss, g = grad(params, {k: jnp.asarray(v) for k, v in b.items()})
        jax.effects_barrier()
        params = jax.tree.map(lambda a, d: a - ETA_L * d, params, g)
        losses.append(float(loss))
    return jax.device_get(params), losses


def port_local(tm, params, batches, sink: list):
    """The same K SGD steps in the port."""
    losses = []
    for b in batches:
        params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with _RecordingMax(sink):
            loss, _ = tm.loss(params, {k: torch.from_numpy(v)
                                       for k, v in b.items()},
                              ParallelContext(), remat_policy="none")
            loss.backward()
        params = tree_map(lambda t: (t - ETA_L * t.grad).detach(), params)
        losses.append(float(loss.detach()))
    return params, losses


def leaf_errs(got, want) -> dict:
    """Each leaf's max |got - want| over its largest |want| (numpy trees or
    the port's, keyed by path)."""
    ref = {"/".join(p): np.asarray(v) for p, v in leaves_with_paths(want)}
    out = {}
    for p, v in leaves_with_paths(got):
        k = "/".join(p)
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = float(np.abs(a - ref[k]).max()
                       / max(float(np.abs(ref[k]).max()), 1e-30))
    return out


def sides(record: list) -> list:
    """Each normalizer call's η side: |η| > exp(-m), elementwise."""
    return [a > b for a, b in record]


def reading(layers: int, seq: int, k_max: int = 2,
            widths: str = "model") -> dict:
    """For K = 1..k_max: the losses, the port's and the moved reference's
    leaf errors against the reference, and per local step and mLSTM layer
    the η side's count and the positions whose side differs from the
    reference's."""
    jm, tm, jp, moved, batches = setup(layers, seq, k_max, widths=widths)
    mlstm = sum(k == "mlstm" for k in tm.cfg.layer_kinds)
    saved, jax_xlstm.jnp = jax_xlstm.jnp, _JNP   # traced with it
    try:
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, JaxCtx(), remat_policy="none")[0]))
        out = {}
        for k in range(1, k_max + 1):
            rec = {"jax": [], "port": [], "moved": []}
            pj, lj = jax_local(grad, jp, batches[:k], rec["jax"])
            pt, lt = port_local(tm, model_params_from_jax(jp, "cpu"),
                                batches[:k], rec["port"])
            pm, lm = jax_local(grad, moved, batches[:k], rec["moved"])
            side = {name: sides(r) for name, r in rec.items()}
            assert all(len(s) == k * mlstm for s in side.values()), \
                {n: len(s) for n, s in side.items()}
            out[k] = {
                "losses": {"jax": lj, "port": lt, "moved": lm},
                "port_vs_jax": leaf_errs(pt, pj),
                "moved_vs_jax": leaf_errs(pm, pj),
                "eta_side": {n: [int(s.sum()) for s in v]
                             for n, v in side.items()},
                "flips": {n: [int((s != j).sum()) for s, j in
                              zip(side[n], side["jax"])]
                          for n in ("port", "moved")},
                "positions": int(side["jax"][0].size),
            }
    finally:
        jax_xlstm.jnp = saved
    return out


def _worst(errs: dict, n: int = 3) -> list:
    return sorted(((round(e, 8), k) for k, e in errs.items()),
                  reverse=True)[:n]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--widths", choices=("model", "smoke"), default="model")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for k, r in reading(args.layers, args.seq, widths=args.widths).items():
        print(f"xlstm-350m ({args.widths}), {args.layers} layers, fp32, batch {BATCH} x "
              f"{args.seq}, K = {k}: losses {r['losses']}")
        print(f"  port vs reference: {_worst(r['port_vs_jax'])}")
        print(f"  reference, every leaf one ulp up, vs reference: "
              f"{_worst(r['moved_vs_jax'])}")
        print(f"  normalizer on the eta side (of {r['positions']} a call, "
              f"per local step and mLSTM layer): {r['eta_side']}; "
              f"positions on the other side than the reference's: "
              f"{r['flips']}")


if __name__ == "__main__":
    main()
