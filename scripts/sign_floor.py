"""The ``sign_ef`` kernel against variants of itself, on one card.

    python3 scripts/sign_floor.py [OTHER_CSRC ...]

Builds ``src/repro_torch/kernels/csrc/sign_ef.cu`` as it is, the same
source from each ``OTHER_CSRC`` directory (for example
``src/repro_torch/kernels/csrc`` of another commit, unpacked; its C entry
point is either this one or the three-launch one of the first port, which
takes a (c,) scale buffer and a tree width), and variants under
``build/sign_floor/``:

* ``load/store floor``: the per-block ‖·‖₁ trees, the arrival, the wait and
  the scales replaced by a fixed scale of 1.0, so the kernel loads, holds
  and stores as it does, on the same grid and layout, but reduces nothing
  and waits for nothing: the floor of its memory traffic;
* ``read twice``: no block held on chip, so every block is read again for
  the write (24 bytes an element instead of 16): what holding saves; and
  the same with 9 KB of shared memory a CTA instead of 221 KB, which
  leaves the SM its L1 for loads in flight;
* ``no wait``: the clients' epochs are not awaited, so each CTA forms its
  scales from whatever partials are there (not checked): the wait's cost;
* ``L1::no_allocate``: the loads of x and err marked not to allocate in
  L1;
* ``8 warps``: a CTA of 8 warps instead of 9, so 27 blocks take 4 rounds
  of a block a warp instead of 3;
* ``timeline``: the kernel as it is, with each CTA's ``%globaltimer`` at
  its start, after its reads, after its scales and at its end; printed as
  min / median / max over the CTAs, from the earliest start.

At the shapes of the FedCAMS round on ConvMixer-256-8 (10 clients ×
d = 704,266), each kernel that computes the scale is held bitwise to its
twin, and each is timed as ``chip_smoke.py`` times (CUDA events, median of
30, L2 flushed), twice: all rows in order, then in reverse order. Prints
the card and a table; writes ``chiprun_out/sign_floor.json``. Needs CUDA.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402

OUT = _build.BUILD_DIR.parent / "sign_floor"
TREE = "const float part = block_l1(t);"
SCALES = ("form_scales(partials, arrivals, lo, hi, nb, d, c_lo, c_hi, red, "
          "cl);")
FIXED_SCALES = ("for (int i = threadIdx.x; i <= c_hi - c_lo; i += kThreads) "
                "cl[i].scale = 1.0f;\n  __syncthreads();")
HELD = "if (r - lo < hold) {"
SMALL = ("if (hold > widest) hold = widest;", "hold = 1;")
WAIT = "while (ld_acquire(arrivals + 2 * ci + 1) == cl[ci - c_lo].epoch) {"
END = "        er[g] = __fsub_rn(t[j], h);\n      }\n    }\n  }\n"
TIMELINE = (
    ("namespace {\n", "namespace {\n\n__device__ unsigned long long "
                      "g_timeline[4096][4];\n"),
    ("  if (lo >= hi) return;\n", "  if (lo >= hi) return;\n  const unsigned "
     "long long tl0 = globaltimer_ns();\n"),
    ("  // 2. the scales", "  __syncthreads();\n  const unsigned long long tl1 "
     "= globaltimer_ns();\n  // 2. the scales"),
    (SCALES, SCALES + "\n  const unsigned long long tl2 = globaltimer_ns();"),
    (END, END + "  __syncthreads();\n  if (threadIdx.x == 0 && blockIdx.x < "
     "4096) {\n    g_timeline[blockIdx.x][0] = tl0;\n    g_timeline[blockIdx"
     ".x][1] = tl1;\n    g_timeline[blockIdx.x][2] = tl2;\n    g_timeline["
     "blockIdx.x][3] = globaltimer_ns();\n  }\n"),
    ("}  // namespace\n", "}  // namespace\n\nextern \"C\" int "
     "sign_ef_timeline(unsigned long long* out) {\n  return static_cast<int>("
     "cudaMemcpyFromSymbol(out, g_timeline, sizeof(g_timeline)));\n}\n"),
)
VARIANTS = {
    "load/store floor": ((TREE, "const float part = t[0];"),
                         (SCALES, FIXED_SCALES)),
    "read twice": ((HELD, "if (r - lo < 0) {"),),
    "read twice, 9 KB smem": ((HELD, "if (r - lo < 0) {"), SMALL),
    "no wait": ((WAIT, "while (false) {"),),
    "L1::no_allocate": (
        ("namespace {\n", "namespace {\n\n__device__ __forceinline__ float "
         "ld_na(const float* p) {\n  float v;\n  asm(\"ld.global."
         "L1::no_allocate.f32 %0, [%1];\" : \"=f\"(v) : \"l\"(p));\n  "
         "return v;\n}\n"), ("__ldcs(", "ld_na(")),
    "8 warps": (("constexpr int kWarps = 9;", "constexpr int kWarps = 8;"),),
    "timeline": TIMELINE,
}
UNCHECKED = ("load/store floor", "no wait")
#: the first port's entry point: (x, err, rows, hat, partials, scale, d, nb,
#: width, c, stream)
THREE_LAUNCH = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]


def variant(name: str, edits) -> Path:
    """An edited copy of the source, in its own directory."""
    d = OUT / re.sub(r"[^0-9A-Za-z]+", "_", name)
    d.mkdir(parents=True, exist_ok=True)
    s = (_build.CSRC / "sign_ef.cu").read_text()
    for old, new in edits:
        assert old in s, f"{name}: {old!r} is not in sign_ef.cu"
        s = s.replace(old, new)
    (d / "sign_ef.cu").write_text(s)
    (d / "sign_ef.cu").write_text(s)
    return d


def build(name: str, src_dir: Path, lib_dir: Path):
    """The entry point built from ``src_dir``, and whether it is the
    three-launch one."""
    lib_dir.mkdir(parents=True, exist_ok=True)
    src = src_dir / "sign_ef.cu"
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_dir / "libsign_ef.so"), str(src)],
                       capture_output=True, text=True)
    log = p.stdout + p.stderr
    if p.returncode:
        cs.fail(f"{name}: sign_ef.cu does not build:\n{log}")
    used = [ln.split("Used")[1].strip() for ln in log.splitlines()
            if "Used" in ln]
    print(f"{name}: {used}")
    three = "float* scale, long long d" in src.read_text()
    lib = ctypes.CDLL(str(lib_dir / "libsign_ef.so"))
    fn = lib.sign_ef_launch
    fn.argtypes = THREE_LAUNCH if three else _build.SIGNATURES["sign_ef"]
    fn.restype = ctypes.c_int
    return lib, fn, three


def timeline(lib, run):
    """One run of the timeline variant: µs from the earliest CTA start to
    each CTA's start, reads done, scales done and end (min, median, max)."""
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (4096 * 4))()
    rc = lib.sign_ef_timeline(buf)
    cs.check(rc == 0, f"timeline read failed with cudaError {rc}")
    t = torch.tensor(list(buf), dtype=torch.float64).view(4096, 4)
    t = t[t[:, 0] > 0]
    t = (t - t[:, 0].min()) / 1e3
    q = torch.quantile(t, torch.tensor([0.0, 0.5, 1.0], dtype=t.dtype), dim=0)
    return {"ctas": t.shape[0], **{
        name: [round(float(v), 3) for v in q[:, i]]
        for i, name in enumerate(("start", "reads done", "scales done",
                                  "end"))}}


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False — this script needs a "
                "card")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    M, C, d = cs.M, cs.N_CLI, 704266
    nb = -(-d // ref.SIGN_BLOCK)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randperm(M, generator=g, device=dev)[:C].contiguous()
    x = torch.randn(C, d, generator=g, device=dev) * 0.01
    err0 = torch.randn(M, d, generator=g, device=dev) * 0.003
    err = err0.clone()
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)

    def restore():
        err.copy_(err0)
        flush.sum()

    def call(fn, three, e):
        hat = torch.empty((C, d), dtype=torch.float32, device=dev)
        partials = torch.empty((C, nb), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if three:
            scale = torch.empty((C,), dtype=torch.float32, device=dev)
            width = min(1 << max(nb - 1, 0).bit_length(), ref.SIGN_CHUNK)
            rc = fn(x.data_ptr(), e.data_ptr(), rows.data_ptr(),
                    hat.data_ptr(), partials.data_ptr(), scale.data_ptr(), d,
                    nb, width, C, stream)
        else:
            rc = fn(x.data_ptr(), e.data_ptr(), rows.data_ptr(),
                    hat.data_ptr(), partials.data_ptr(),
                    ops._sign_arrivals(dev, C).data_ptr(), d, nb, C, stream)
        cs.check(rc == 0, f"launch failed with cudaError {rc}")
        return [hat, e]

    runs = {"as built": lambda e: [
        ops.sign_ef_cuda(x, e, rows, check_rows=False), e]}
    dirs = {name: variant(name, edits) for name, edits in VARIANTS.items()}
    dirs.update({other: Path(other).resolve() for other in sys.argv[1:]})
    libs = {}
    for i, (name, src_dir) in enumerate(dirs.items()):
        libs[name], fn, three = build(name, src_dir, OUT / f"lib{i}")
        runs[name] = lambda e, f=fn, t=three: call(f, t, e)
    for name, run in runs.items():
        if name in UNCHECKED:
            continue
        e_k, e_r = err0.clone(), err0.clone()
        got = run(e_k)
        cs.same(f"sign_ef [{name}]", got, [ref.sign_ef(x, e_r, rows), e_r])
    res = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            res[name].append(cs.time_ms(lambda r=runs[name]: r(err), restore))
    nbytes = C * d * 16 + C * 8
    print("µs (in order, reversed)")
    for name, t in res.items():
        print(f"{name[-24:]:<24} {t[0] * 1e3:>8.1f} {t[1] * 1e3:>8.1f}")
    print(f"{'bound':<24} {nbytes / cs.PEAK_BYTES_S * 1e6:>17.1f}")
    restore()
    tl = timeline(libs["timeline"], lambda: runs["timeline"](err))
    print(f"timeline over {tl.pop('ctas')} CTAs, µs from the first start "
          f"(min, median, max):")
    for phase, q in tl.items():
        print(f"  {phase:<12} {q}")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "sign_floor.json").write_text(json.dumps(
        {"card": card, "ms": res, "bytes": nbytes, "timeline_us": tl,
         "shapes": f"x ({C},{d}) f32, err ({M},{d}) f32, {nb} blocks of "
                   f"{ref.SIGN_BLOCK} per client"}, indent=1))


if __name__ == "__main__":
    main()
