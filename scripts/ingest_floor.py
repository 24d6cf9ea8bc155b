"""The ``fedams_ingest`` kernel against other commits', diagnostic variants
of each and its load/store floor, on one card.

    python3 scripts/ingest_floor.py [OTHER_CSRC ...]

At the shapes of a FedCAMS round on ConvMixer-256-8 with the fused server
ingest (d = 704,266, blocks of 2048, nb = 344, n = 10 clients, k = 32;
the selections from ``ref.topk_ef_sparse`` as ``chip_smoke.py`` makes
them) it times, with CUDA events as ``chip_smoke.py`` times (median of 30,
L2 flushed before each), all rows in order, then in reverse order:

* the kernel as built (``src/repro_torch/kernels/csrc/fedams_ingest.cu``)
  and each ``OTHER_CSRC``'s ``fedams_ingest.cu`` (``src/repro_torch/
  kernels/csrc`` of another commit, unpacked, for example the parent with
  ``git archive <commit> | tar -x -C build/parent``), at fp32, bf16 and
  int8 state, option 1;
* diagnostic variants of each source whose design it knows, made by
  editing it under ``build/ingest_floor/`` (``DESIGNS``): "state stream
  only" (the selection phase taken out: the FedAMS step on a zero mean
  delta, with the same loads and stores) and "selections only" (stops
  after the scatter-mean); for the current design also "no div/sqrt" (the
  arithmetic's cost) and a per-CTA ``%globaltimer`` timeline;
* the load/store floor of each dtype's exact bytes: a kernel that reads
  each input byte once and writes each output byte once as 16-byte words
  (an XOR folds the loads into the stores, so none is dropped); and an
  empty kernel: what one launch costs in this timing.

Every kernel is held bitwise to the twin (``ref.fedams_ingest_ref``), the
"state stream only" variants to the twin on zero deltas, "selections
only" to the twin's scatter sum at each block's first position, the
timeline variant to the twin. Prints the card and a table; writes
``chiprun_out/ingest_floor.json``. Needs CUDA.
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

from repro_torch.kernels import _build, ref  # noqa: E402

OUT = _build.BUILD_DIR.parent / "ingest_floor"
DTYPES = ("float32", "bfloat16", "int8")
SCATTER = "  scatter_mean(acc, stage, vals, idx, p, b, start);\n"
#: the timeline: %globaltimer of each CTA at its start, once its sums are
#: in, after the step of its last quad and at its end (all its threads),
#: and the SM it ran on
TIMELINE = (
    ("namespace {\n", "namespace {\n\n__device__ unsigned long long "
     "g_timeline[4096][5];\n\n__device__ __forceinline__ unsigned long long "
     "globaltimer_ns() {\n  unsigned long long t;\n  asm volatile(\"mov.u64 "
     "%0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("  const int rounds = (p.block + kRound - 1) / kRound;\n",
     "  const int rounds = (p.block + kRound - 1) / kRound;\n"
     "  const unsigned long long tl0 = globaltimer_ns();\n"),
    (SCATTER, SCATTER + "  const unsigned long long tl1 = "
     "globaltimer_ns();\n"),
    ("  if constexpr (kDtype == 2) {\n    // 4.", "  __syncthreads();\n  "
     "const unsigned long long tl2 = globaltimer_ns();\n  if constexpr "
     "(kDtype == 2) {\n    // 4."),
    ("      vhs_out[b] = sh2;\n    }\n  }\n}\n", "      vhs_out[b] = sh2;\n"
     "    }\n  }\n  __syncthreads();\n  if (tid == 0 && b < 4096) {\n    "
     "g_timeline[b][0] = tl0;\n    g_timeline[b][1] = tl1;\n    "
     "g_timeline[b][2] = tl2;\n    g_timeline[b][3] = globaltimer_ns();\n"
     "    unsigned smid;\n    asm volatile(\"mov.u32 %0, %%smid;\" : "
     "\"=r\"(smid));\n    g_timeline[b][4] = smid;\n"
     "  }\n}\n"),
    ("}  // namespace\n", "}  // namespace\n\nextern \"C\" int "
     "ingest_timeline(unsigned long long* out) {\n  return static_cast<int>("
     "cudaMemcpyFromSymbol(out, g_timeline, sizeof(g_timeline)));\n}\n"),
)
#: design → (marker in its source, variant → edits). "state stream only"
#: takes the selection phase out (held to the twin on zero deltas);
#: "selections only" stops after the scatter-mean and writes each block's
#: first sum to x_out[b] (held to the twin's sums); "no div/sqrt"
#: replaces every division and square root by a multiply or nothing (not
#: checked): what the arithmetic costs; "timeline" is the kernel as it is,
#: with each CTA's %globaltimer at its phases (held to the twin). Another
#: commit's source of neither design is built as it is, without variants.
DESIGNS = {
    "first port": ("for (int j = 0; j < p.n; ++j) {", {
        "state stream only": (
            ("for (int j = 0; j < p.n; ++j) {",
             "for (int j = 0; j < 0; ++j) {"),),
        "selections only": (
            ("  const float sv = kDtype == 2 ? v_scale[b] : 1.0f;\n",
             "  if (tid == 0) x_out[b] = acc[0];\n  return;\n"
             "  const float sv = kDtype == 2 ? v_scale[b] : 1.0f;\n"),)}),
    "staged": (SCATTER, {
        "state stream only": (
            ("  const Fetch f = fetch(vals, idx, p, b, first);\n", ""),
            ("  stage_pass(stage, f, first, p, start);\n", ""),
            (SCATTER, "  __syncthreads();\n")),
        "selections only": (
            (SCATTER, SCATTER + "  if (tid == 0) x_out[b] = acc[0];\n"
             "  return;\n"),),
        "no div/sqrt": (
            ("      *a = __fdiv_rn(*a, p.n_div);\n", ""),
            ("    den[e] = sqrt_seq(vh2[e]);\n", "    den[e] = vh2[e];\n"),
            ("      x2[e] = __fadd_rn(xv[e], div_seq(num[e], den[e]));",
             "      x2[e] = __fadd_rn(xv[e], __fmul_rn(num[e], den[e]));"),
            ("rintf(__fdiv_rn(v, s))", "rintf(__fmul_rn(v, s))")),
        "timeline": TIMELINE}),
}
UNCHECKED = ("no div/sqrt",)


FLOOR_CU = r"""
#include <cuda_runtime.h>

// thread i: reads input words i, i + n_out, i + 2 n_out, ... and writes
// output word i, so every input word is read once and every output word
// written once
__global__ void floor_kernel(const uint4* __restrict__ in, long long n_in,
                             uint4* __restrict__ out, long long n_out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (long long j = i; j < n_in; j += n_out) {
    const uint4 v = in[j];
    acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
  }
  out[i] = acc;
}

__global__ void empty_kernel() {}

extern "C" int floor_launch(const void* in, long long n_in, void* out,
                            long long n_out, void* stream) {
  floor_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0,
                 (cudaStream_t)stream>>>((const uint4*)in, n_in,
                                         (uint4*)out, n_out);
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def design(src: str):
    for name, (marker, _) in DESIGNS.items():
        if marker in src:
            return name
    return None


def sources(others):
    """tag → text of every source to build: each given source and its
    design's variants, tagged ``"<variant> [<source tag>]"``; a variant
    whose edits another commit's version of the design does not take is
    left out."""
    out = {}
    for tag, src_dir in [("as built", _build.CSRC)] + [
            (f"other {i}: {o}", Path(o).resolve())
            for i, o in enumerate(others)]:
        text = (src_dir / "fedams_ingest.cu").read_text()
        out[tag] = text
        known = design(text)
        cs.check(known is not None or tag != "as built",
                 "fedams_ingest.cu: no known design's marker is in it")
        for what, edits in (DESIGNS[known][1] if known else {}).items():
            s = text
            for old, new in edits:
                if old not in s:   # another commit's version of the design
                    cs.check(tag != "as built",
                             f"{tag}: {old!r} is not in the source")
                    print(f"{tag}: no {what!r} variant ({old!r} is not in "
                          f"its source)")
                    break
                s = s.replace(old, new)
            else:
                out[f"{what} [{tag}]"] = s
    return out


def build_all(texts: dict) -> dict:
    """Every source with ``nvcc`` at once → tag → the loaded library."""
    procs = {}
    for i, (tag, text) in enumerate(texts.items()):
        d = OUT / f"src{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "fedams_ingest.cu").write_text(text)
        lib = d / "libfedams_ingest.so"
        procs[tag] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "fedams_ingest.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"{tag}: fedams_ingest.cu does not build:\n{log}")
        used = [ln.split("Used")[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{tag}: {used}")
        lib = ctypes.CDLL(str(lib))
        lib.fedams_ingest_launch.argtypes = _build.SIGNATURES["fedams_ingest"]
        lib.fedams_ingest_launch.restype = ctypes.c_int
        fns[tag] = lib
    return fns


def timeline(lib, nb: int):
    """The timeline variant's last launch: µs from the earliest CTA start
    to each CTA's start, sums in, step done and end (min, median, max over
    the CTAs); prints the CTAs' ends by how many CTAs their SM held."""
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (4096 * 5))()
    rc = lib.ingest_timeline(buf)
    cs.check(rc == 0, f"timeline read failed with cudaError {rc}")
    raw = torch.tensor(list(buf), dtype=torch.float64).view(4096, 5)[:nb]
    sm = raw[:, 4].long()
    per_sm = torch.bincount(sm)[sm]          # CTAs on each CTA's SM
    t = raw[:, :4]
    t = (t - t[:, 0].min()) / 1e3
    for c in per_sm.unique().tolist():
        e = t[per_sm == c, 3]
        print(f"  CTAs on SMs holding {c}: {int((per_sm == c).sum())}, end "
              f"median {float(e.median()):.3f} max {float(e.max()):.3f} µs")
    last = int(t[:, 3].argmax())
    print(f"  last CTA: block {last}, its SM holds {int(per_sm[last])}")
    q = torch.quantile(t, torch.tensor([0.0, 0.5, 1.0], dtype=t.dtype), dim=0)
    return {name: [round(float(v), 3) for v in q[:, i]]
            for i, name in enumerate(("start", "sums in", "step done",
                                      "end"))}


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False — this script needs a "
                "card")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    n, d, blk = cs.N_CLI, 704266, cs.BLOCK
    nb, k = -(-d // blk), max(1, int(round(cs.RATIO * blk)))
    N = nb * blk
    hp = dict(n_div=n, eta=0.1, beta1=0.9, beta2=0.99, eps=1e-4, option=1,
              block=blk)
    g = torch.Generator(device=dev).manual_seed(0)
    tot = torch.randn(n, d, generator=g, device=dev)
    vals, idx = ref.topk_ef_sparse(tot, torch.zeros(n, d, device=dev),
                                   torch.arange(n, device=dev), k=k,
                                   block=blk)
    vals = vals * 0.01
    x = torch.randn(d, generator=g, device=dev)
    m = torch.randn(d, generator=g, device=dev) * 1e-3
    v32 = torch.rand(d, generator=g, device=dev) * 1e-4
    vh32 = v32 + torch.rand(d, generator=g, device=dev) * 1e-4
    q = torch.randint(0, 128, (N,), generator=g, device=dev,
                      dtype=torch.int8)
    qh = torch.randint(0, 128, (N,), generator=g, device=dev,
                       dtype=torch.int8)
    sc = torch.rand(nb, generator=g, device=dev) * 1e-6 + 1e-7
    state = {"float32": (v32, vh32, None, None),
             "bfloat16": (v32.bfloat16(), vh32.bfloat16(), None, None),
             "int8": (q, qh, sc, sc * 1.5)}
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)
    sel = vals.numel() * 8

    def evict():
        flush.sum()

    def nbytes(sd):
        """(bytes read, bytes written) of one call."""
        s = {"float32": 4 * d, "bfloat16": 2 * d, "int8": N + 4 * nb}[sd]
        return 2 * 4 * d + 2 * s + sel, 2 * 4 * d + 2 * s

    def call(fn, sd, dv):
        """One launch → the outputs, as the wrapper returns them."""
        v, vh, vs, vhs = state[sd]
        o = [torch.empty_like(t) for t in (x, m, v, vh)]
        o += [torch.empty_like(sc) for _ in range(2)] if sd == "int8" else \
            [None, None]
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = fn(ptr(x), ptr(m), ptr(v), ptr(vh), ptr(dv), ptr(idx), ptr(vs),
                ptr(vhs), *map(ptr, o), d, blk, n, nb, k, float(n), 0.9,
                float(1.0 - 0.9), 0.99, float(1.0 - 0.99), 0.1, 1e-4, 1,
                DTYPES.index(sd), torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"launch failed with cudaError {rc}")
        return o[:4] + (o[4:] if sd == "int8" else [])

    def twin(sd, dv):
        v, vh, vs, vhs = state[sd]
        args = (x, m, v, vh, dv, idx) + ((vs, vhs) if sd == "int8" else ())
        return ref.fedams_ingest_ref(*args, state_dtype=sd, **hp)

    libs = build_all(sources(sys.argv[1:]))
    zero = torch.zeros_like(vals)
    first = ref.scatter_mean_padded(vals, idx, N, 1.0)[::blk]
    runs, timelines = {}, {}
    for tag, lib in libs.items():
        fn = lib.fedams_ingest_launch
        if tag.startswith("selections only"):
            got = call(fn, "float32", vals)
            torch.cuda.synchronize()
            cs.check(torch.equal(got[0][:nb], first),
                     f"{tag}: block sums differ from the twin's")
            runs[tag] = lambda f=fn: call(f, "float32", vals)
            continue
        dv = zero if tag.startswith("state stream only") else vals
        for sd in DTYPES:
            got = call(fn, sd, dv)
            if not tag.startswith(UNCHECKED):
                cs.same(f"{tag}, {sd}", got, twin(sd, dv))
            run = lambda f=fn, s=sd, v_=dv: call(f, s, v_)
            if tag.startswith("timeline"):
                timelines[f"{tag}, {sd}"] = (lib, run)
            else:
                runs[f"{tag}, {sd}"] = run

    # the load/store floor of each dtype's bytes, and one empty launch
    (OUT / "floor").mkdir(parents=True, exist_ok=True)
    (OUT / "floor" / "floor.cu").write_text(FLOOR_CU)
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(OUT / "floor" / "libfloor.so"),
                        str(OUT / "floor" / "floor.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        cs.fail(f"floor.cu does not build:\n{p.stdout}{p.stderr}")
    flib = ctypes.CDLL(str(OUT / "floor" / "libfloor.so"))
    flib.floor_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p]
    flib.empty_launch.argtypes = [ctypes.c_void_p]
    flib.floor_launch.restype = flib.empty_launch.restype = ctypes.c_int
    src = torch.empty(nbytes("float32")[0] // 16 + 1, 4, dtype=torch.int32,
                      device=dev)
    dst = torch.empty_like(src)

    def floor(sd):
        r, w = nbytes(sd)

        def run():
            rc = flib.floor_launch(src.data_ptr(), -(-r // 16),
                                   dst.data_ptr(), -(-w // 16),
                                   torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"floor launch failed with cudaError {rc}")
        return run

    for sd in DTYPES:
        runs[f"load/store floor, {sd}"] = floor(sd)
    runs["empty launch"] = lambda: cs.check(flib.empty_launch(
        torch.cuda.current_stream().cuda_stream) == 0, "empty launch failed")

    res = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            res[name].append(cs.time_ms(runs[name], evict))
    for name, (lib, run) in timelines.items():   # the last of a timed few
        cs.time_ms(run, evict, iters=3)
        timelines[name] = timeline(lib, nb)
    bounds = {sd: sum(nbytes(sd)) for sd in DTYPES}
    print("µs (in order, reversed); bound = bytes / "
          f"{cs.PEAK_BYTES_S / 1e12} TB/s: " + ", ".join(
              f"{sd} {b} B, {b / cs.PEAK_BYTES_S * 1e6:.2f} µs"
              for sd, b in bounds.items()))
    for name, t in res.items():
        print(f"{name:<64} {t[0] * 1e3:>8.2f} {t[1] * 1e3:>8.2f}")
    for name, t in timelines.items():
        print(f"{name}: µs (min, median, max over CTAs) {t}")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "ingest_floor.json").write_text(json.dumps(
        {"card": card, "ms": res, "timelines": timelines,
         "bound_bytes": bounds,
         "bound_ms": {sd: b / cs.PEAK_BYTES_S * 1e3
                      for sd, b in bounds.items()},
         "shapes": f"d={d}, block={blk}, vals/idx ({n},{nb},{k}), option 1"},
        indent=1))


if __name__ == "__main__":
    main()
