"""The top-k kernels against variants of themselves, on one card.

    python3 scripts/topk_floor.py [OTHER_CSRC ...]

Builds ``src/repro_torch/kernels/csrc/topk_ef_sparse.cu`` and ``topk_ef.cu``
as they are, the same two sources from each ``OTHER_CSRC`` directory (for
example ``src/repro_torch/kernels/csrc`` of another commit, unpacked; their
C entry points must be these), and variants under ``build/topk_floor/``:

* ``kMinBlocks`` = 4 and 6 (the sources say 5): the register budget
  against the CTAs an SM holds;
* ``no select``: the membership replaced by a fixed set of k picks, so the
  kernel loads, stores and (sparse) sorts as it does, but selects nothing:
  the floor of its memory traffic at this grid and layout.

At the shapes of the FedCAMS round on ConvMixer-256-8 (10 clients ×
d = 704,266, blocks of 2048, k = 32), each kernel that selects is held
bitwise to its twin, and each is timed as ``chip_smoke.py`` times (CUDA
events, median of 30, L2 flushed), twice: all rows in order, then in
reverse order. Prints the card and a table; writes
``chiprun_out/topk_floor.json``. Needs CUDA.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402

OUT = _build.BUILD_DIR.parent / "topk_floor"
SELECT = ("const topk::Threshold t = topk::find_threshold(v, in, k, s);\n"
          "  const unsigned keep = topk::keep_mask(v, in, t, s);")
FIXED = "const unsigned keep = tid < k ? 1u : 0u;   // picks 0..k-1"
VARIANTS = {"kMinBlocks=4": (4, False), "kMinBlocks=6": (6, False),
            "no select": (5, True)}


def variant(name: str, min_blocks: int, no_select: bool) -> Path:
    """Edited copies of the sources, in their own directory."""
    d = OUT / name.replace(" ", "_").replace("=", "")
    d.mkdir(parents=True, exist_ok=True)
    for f in ("topk_select.cuh", "topk_ef_sparse.cu", "topk_ef.cu"):
        s = (_build.CSRC / f).read_text()
        if f.endswith(".cuh"):
            assert "kMinBlocks = 5;" in s
            s = s.replace("kMinBlocks = 5;", f"kMinBlocks = {min_blocks};")
        elif no_select:
            assert SELECT in s
            s = s.replace(SELECT, FIXED)
        (d / f).write_text(s)
    return d


def build(name: str, src_dir: Path, lib_dir: Path):
    """The two kernels' entry points, built from ``src_dir``."""
    lib_dir.mkdir(parents=True, exist_ok=True)
    procs = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(lib_dir / f"lib{src}.so"), str(src_dir / f"{src}.cu")],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for src in ("topk_ef_sparse", "topk_ef")}
    fns = {}
    for src, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            cs.fail(f"{name}: {src}.cu does not build:\n{log}")
        used = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{name} {src}: {used}")
        fn = getattr(ctypes.CDLL(str(lib_dir / f"lib{src}.so")),
                     f"{src}_launch")
        fn.argtypes = _build.SIGNATURES[src]
        fn.restype = ctypes.c_int
        fns[src] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False — this script needs a "
                "card")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    M, C, d, block = cs.M, cs.N_CLI, 704266, cs.BLOCK
    k = max(1, int(round(cs.RATIO * block)))
    nb = -(-d // block)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randperm(M, generator=g, device=dev)[:C].contiguous()
    x = torch.randn(C, d, generator=g, device=dev) * 0.01
    err0 = torch.randn(M, d, generator=g, device=dev) * 0.003
    err = err0.clone()
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)

    def restore():
        err.copy_(err0)
        flush.sum()

    def sparse(fn, e):
        vals = torch.empty((C, nb, k), dtype=torch.float32, device=dev)
        idx = torch.empty((C, nb, k), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), e.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), d, block, nb, k, C, stream)
        cs.check(rc == 0, f"launch failed with cudaError {rc}")
        return [vals, idx, e]

    def dense(fn, e):
        hat = torch.empty((C, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), e.data_ptr(), rows.data_ptr(), hat.data_ptr(),
                d, block, nb, k, C, stream)
        cs.check(rc == 0, f"launch failed with cudaError {rc}")
        return [hat, e]

    runs = {"as built": {
        "topk_ef_sparse": lambda e: [*ops.topk_ef_sparse_cuda(
            x, e, rows, k=k, block=block, check_rows=False), e],
        "topk_ef": lambda e: [ops.topk_ef_cuda(
            x, e, rows, k=k, block=block, check_rows=False), e]}}
    dirs = {name: variant(name, *spec) for name, spec in VARIANTS.items()}
    dirs.update({other: Path(other).resolve() for other in sys.argv[1:]})
    for i, (name, src_dir) in enumerate(dirs.items()):
        fns = build(name, src_dir, OUT / f"lib{i}")
        runs[name] = {"topk_ef_sparse": lambda e, f=fns: sparse(
            f["topk_ef_sparse"], e), "topk_ef": lambda e, f=fns: dense(
            f["topk_ef"], e)}
    twins = {"topk_ef_sparse": lambda e: [*ref.topk_ef_sparse(
        x, e, rows, k=k, block=block), e],
        "topk_ef": lambda e: [ref.topk_ef(x, e, rows, k=k, block=block), e]}
    for name, kernels in runs.items():
        for kname, run in kernels.items():
            if not VARIANTS.get(name, (5, False))[1]:
                cs.same(f"{kname} [{name}]", run(err0.clone()),
                        twins[kname](err0.clone()))
    res = {name: {kname: [] for kname in kernels}
           for name, kernels in runs.items()}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            for kname, run in runs[name].items():
                res[name][kname].append(cs.time_ms(
                    lambda r=run: r(err), restore))
    bytes_ = {"topk_ef_sparse": C * d * 12 + C * nb * k * 8 + C * 8,
              "topk_ef": C * d * 16 + C * 8}
    print("µs (in order, reversed)  " + "  ".join(f"{n:>18}" for n in bytes_))
    for name, t in res.items():
        print(f"{name[-24:]:<24} " + "  ".join(
            f"{t[n][0] * 1e3:>8.1f} {t[n][1] * 1e3:>8.1f}" + " " * 2
            for n in bytes_))
    print(f"{'bound':<24} " + "  ".join(
        f"{b / cs.PEAK_BYTES_S * 1e6:>17.1f}  " for b in bytes_.values()))
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "topk_floor.json").write_text(json.dumps(
        {"card": card, "ms": res, "bytes": bytes_,
         "shapes": f"x ({C},{d}) f32, err ({M},{d}) f32, k={k}, "
                   f"block={block}"}, indent=1))


if __name__ == "__main__":
    main()
