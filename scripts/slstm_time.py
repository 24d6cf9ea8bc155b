"""One sLSTM layer's forward and backward timed on the card: the port's
loop over ``pre.unbind(1)`` against ``chip_smoke.py``'s
``witness_slstm_train``, the loop that indexed ``pre[:, i]`` a step and so
wrote each step's gradient into a zero-filled (B, S, 4d) tensor (ROADMAP
Queue 3 item 32).

    python3 -u scripts/slstm_time.py

Needs a card. At xlstm-350m's widths, batch 16 x 4,096, fp32
(``chip_smoke.py``'s ``z_slstm_case`` at ``Z_SEQ``), each form computes
its output and the gradients of ∑ out·R for every param and for x; the
two forms alternate, ``ITERS`` times each. Prints and writes to
``chiprun_out/slstm_time.json``, beside the card's name and power limit:
each form's CUDA-event ms (median and all), its peak memory above what
was allocated before, and
``launch/op_analysis``'s bytes and ops of it on meta with the HBM floor
(bytes / 3.35 TB/s). ``chip_smoke.py`` route z holds the two forms equal
to the bit at S = 512.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 5


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # puts ROOT/src first

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a card")
    from repro_torch.launch import op_analysis as oa
    from repro_torch.models import xlstm as xm

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    S = cs.Z_SEQ
    p, x, R = cs.z_slstm_case(S)
    forms = {"unbind": xm.slstm_train, "witness": cs.witness_slstm_train}
    out = {name: {"ms_all": [], "peak": []} for name in forms}
    for name, fn in forms.items():
        meta = oa.analyze(lambda pp, xx, f=fn: cs._z_fwd_bwd(
            f, pp, xx, cs._on_meta(R)), *cs._on_meta((p, x)))
        out[name].update(meta_bytes=meta.bytes, meta_ops=meta.ops,
                         hbm_floor_ms=meta.bytes / cs.PEAK_BYTES_S * 1e3)
    for _ in range(ITERS):
        for name, fn in forms.items():
            cs._sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = cs._z_fwd_bwd(fn, p, x, R)
            b.record()
            b.synchronize()
            out[name]["ms_all"].append(a.elapsed_time(b))
            out[name]["peak"].append(torch.cuda.max_memory_allocated() - base)
            cs.check(all(bool(torch.isfinite(t).all()) for t in res),
                     f"the sLSTM's {name} form at S = {S} is not "
                     f"finite")
            del res
    for name, r in out.items():
        r["ms"] = float(np.median(r["ms_all"]))
        r["peak_gb"] = max(r.pop("peak")) / 1e9
        print(f"[{card}] one sLSTM layer, batch {cs.Z_BATCH} x {S}, "
              f"fp32, forward + backward, {name}: {r['ms']:.1f} ms median of "
              f"{ITERS} (all {[round(t, 1) for t in r['ms_all']]}), "
              f"peak {r['peak_gb']:.2f} GB; meta {r['meta_bytes']:,} bytes "
              f"(HBM floor {r['hbm_floor_ms']:.1f} ms), {r['meta_ops']:,} ops")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "slstm_time.json").write_text(json.dumps(
        {"card": card, "seq": S, "batch": cs.Z_BATCH,
         "iters": ITERS, "forms": out}, indent=1))


if __name__ == "__main__":
    main()
