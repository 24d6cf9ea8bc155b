"""One layer's forward and backward reckoned on ``meta``: the sequential
loops' bytes against the sequence length (ROADMAP Queue 3 item 32).

    PYTHONPATH=src python scripts/layer_bytes.py [--src OTHER_SRC]

Runs on a CPU: every tensor is ``meta``, so nothing is allocated and no
number is a device reading. Each case is the gradient of ∑ out·R for
every param and for x, counted by ``launch/op_analysis`` (``measure``: a
full trace, no loop capped) at batch 16 and tp 1:

* the sLSTM layer at xlstm-350m's widths, fp32, S = 512 and 4,096: the
  port's loop and ``chip_smoke.py``'s ``witness_slstm_train`` (the loop
  that indexed ``pre[:, i]`` a step): bytes, ops and the HBM floor
  (bytes / 3.35 TB/s);
* the chunkwise mLSTM (chunk 256, the config's bf16) at S = 1,024, 2,048
  and 4,096;
* at S = 4,096, chunk 2048 (the dry run's): gemma2-2b's attention layer,
  deepseek-v3's MLA and xlstm-350m's quadratic mLSTM, with the bytes
  charged to ``slice_backward`` along the sequence (each q-chunk's
  gradient written into a zero-filled copy of the whole tensor).

The sLSTM's loop is counted by ``analyze`` (its trips extrapolated, equal
to a full trace: ``tests/test_torch_op_analysis.py``), the rest by
``measure``.

``--src`` reckons another tree's ``repro_torch`` (the parent's
``src``, unpacked with ``git archive``) with this tree's witness.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

B = 16
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3 (data sheet)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import witness_slstm_train   # puts ROOT/src first
    sys.path.insert(0, args.src)

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import op_analysis as oa
    from repro_torch.models import params as pdefs
    from repro_torch.models import stack as st
    from repro_torch.models import xlstm as xm
    from repro_torch.sharding.rules import ParallelContext

    ctx = ParallelContext()

    class BySlice(oa.OpCost):
        """OpCost that also sums the bytes charged to ``slice_backward``
        along dim 1, the sequence."""

        def __init__(self):
            super().__init__()
            self.seq_slices = 0

        def _charge(self, func, args, kwargs, out):
            before = self.cost.bytes
            super()._charge(func, args, kwargs, out)
            if func.overloadpacket is torch.ops.aten.slice_backward and \
                    args[2] == 1:
                self.seq_slices += self.cost.bytes - before

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def count(layer, defs, S, d, dtype, trips=False):
        """The gradient of ∑ layer(p, x)·R for every param and x: the
        recorder of a full trace, or with ``trips`` ``analyze``'s cost."""
        p = pdefs.tree_map(lambda dd: meta(dd.shape, getattr(torch, dd.dtype)),
                           defs)
        x, R = meta((B, S, d), getattr(torch, dtype)), meta((B, S, d))

        def fwd_bwd(p, x):
            leaves = [t.requires_grad_(True) for t in pdefs.tree_leaves(p)]
            out = layer(p, x.requires_grad_(True))
            return torch.autograd.grad((out.float() * R).sum(), leaves + [x])

        if trips:
            return oa.analyze(fwd_bwd, p, x)
        rec = BySlice()
        with rec:
            rec.add_arguments((p, x))
            fwd_bwd(p, x)
        return rec

    xl = get_arch("xlstm-350m").model
    print("sLSTM layer, xlstm-350m widths, batch 16, fp32:")
    sdefs = xm.slstm_defs(xl.d_model, xl.num_heads, xl.xlstm)
    for S in (512, 4096):
        for name, fn in (("port", xm.slstm_train),
                         ("pre[:, i] witness", witness_slstm_train)):
            c = count(lambda p, x: fn(p, x, xl.num_heads, ctx, "float32"),
                      sdefs, S, xl.d_model, "float32", trips=True)
            print(f"  S = {S:>5}, {name:>17}: {c.bytes:,} bytes "
                  f"(HBM floor {c.bytes / PEAK_BYTES_S:.4f} s), {c.ops:,} ops")

    print("chunkwise mLSTM, xlstm-350m widths, chunk 256, batch 16, bf16:")
    mdefs = xm.mlstm_defs(xl.d_model, xl.num_heads, xl.xlstm)
    for S in (1024, 2048, 4096):
        c = count(lambda p, x: xm.mlstm_train_chunkwise(
            p, x, xl.num_heads, ctx, xl.dtype, chunk=256), mdefs, S,
            xl.d_model, xl.dtype).cost
        print(f"  S = {S:>5}: {c.bytes:,} bytes")

    print("one layer at S = 4,096, chunk 2048, batch 16, tp 1 "
          "(bytes; of them slice_backward's along the sequence):")
    for arch in ("gemma2-2b", "deepseek-v3-671b", "xlstm-350m"):
        cfg = get_arch(arch).model
        dims = st._dims(cfg, 1)
        desc = st.LayerDesc("mlstm" if cfg.xlstm else "attn", 0)
        defs = st.layer_defs(cfg, desc, dims, 1)["mix"]
        if cfg.xlstm:
            layer = lambda p, x: st._mlstm(p, x, cfg, ctx, 2048)
        else:
            layer = lambda p, x: st._attn_mix(p, x, cfg, desc, dims, ctx,
                                              2048)[0]
        rec = count(layer, defs, 4096, cfg.d_model, cfg.dtype)
        print(f"  {arch} ({desc.kind}): {rec.cost.bytes:,} bytes; "
              f"slice_backward {rec.seq_slices:,}")


if __name__ == "__main__":
    main()
