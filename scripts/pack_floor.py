"""The bitpack kernels against the per-row kernel of another commit and
their load/store floor, on one card.

    python3 scripts/pack_floor.py [OTHER_CSRC]

At the shapes of a FedCAMS round on ConvMixer-256-8 over the packed wire
(10 clients, d = 704,266; blocktopk 1/64 with 344 blocks of 2048 and 32
picks, so 11,008 offsets of 11 bits a client) it times, with CUDA events
as ``chip_smoke.py`` times (median of 30, L2 flushed before each), all rows
in order, then in reverse order:

* the kernels as built, one launch for the 10 rows: the sign codec's
  fused pack (fp32 totals → ``>= 0`` bits into 88,054-byte messages at
  column 20) and fused unpack (→ fp32 ``scale · ±1``), the same pack from
  uint8 bits and unpack to uint8 bits, and the n = 11 offsets into and out
  of 59,184-byte messages at column 16;
* ``OTHER_CSRC``'s ``bitpack.cu`` (``src/repro_torch/kernels/csrc`` of
  another commit, unpacked, for example the parent with ``git archive
  <commit> | tar -x -C build/parent``), launched once a row, 10 times, as
  the per-client codec loop launched it; the per-row entry point of the
  first port (uint8 bits in, uint8 bits out) is detected from its source;
* the load/store floor: a kernel that reads each input byte once and
  writes each output byte once as 16-byte words (an XOR folds the loads
  into the stores, so none is dropped), for each pair's bytes, and an
  empty kernel: what one launch costs in this timing.

Each kernel as built is held bitwise to its twin, and the other commit's
outputs to the twin's. Prints the card and a table; writes
``chiprun_out/pack_floor.json``. Needs CUDA.
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

OUT = _build.BUILD_DIR.parent / "pack_floor"
FLOOR_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// warp w: outputs [32w, 32w + 32) and inputs [32w*r, 32(w+1)*r), r = the
// inputs an output stands for (>= 1); or, with r < 0, -r outputs an input
__global__ void floor_kernel(const uint4* __restrict__ in, long long n_in,
                             uint4* __restrict__ out, long long n_out,
                             int r) {
  const long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (r > 0) {
    for (int j = 0; j < r; ++j) {
      const long long i = 32 * w * r + 32LL * j + lane;
      if (i < n_in) {
        const uint4 v = in[i];
        acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
      }
    }
    if (32 * w + lane < n_out) out[32 * w + lane] = acc;
  } else {
    if (32 * w + lane < n_in) acc = in[32 * w + lane];
    for (int j = 0; j < -r; ++j) {
      const long long o = 32 * w * -r + 32LL * j + lane;
      if (o < n_out) out[o] = make_uint4(acc.x ^ j, acc.y, acc.z, acc.w);
    }
  }
}

__global__ void empty_kernel() {}

extern "C" int floor_launch(const void* in, long long n_in, void* out,
                            long long n_out, int r, void* stream) {
  const long long warps = r > 0 ? (n_out + 31) / 32 : (n_in + 31) / 32;
  const long long blocks = (warps * 32 + 255) / 256;
  floor_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, n_in, (uint4*)out, n_out, r);
  return (int)cudaGetLastError();
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the first port's per-row entry points
ROW_PACK = [_P, _P, _LL, _I, _I, _P]
ROW_UNPACK = [_P, _LL, _P, _LL, _I, _I, _P]


def nvcc(src: Path, lib: Path) -> ctypes.CDLL:
    lib.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if p.returncode:
        cs.fail(f"{src} does not build:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(lib))


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def launched(rc, what):
    cs.check(rc == 0, f"{what}: launch failed with cudaError {rc}")


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False — this script needs a "
                "card")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    C, d, nb, k, ib = cs.N_CLI, 704266, 344, 32, 11
    n1, n11 = (d + 7) // 8, (nb * k * ib + 7) // 8
    sign_w, topk_w = 20 + n1, 16 + n11 + 4 * nb * k
    g = torch.Generator(device=dev).manual_seed(0)
    tot = torch.randn(C, d, generator=g, device=dev)
    bits = (tot >= 0).to(torch.uint8)
    li = torch.randint(0, 2048, (C, nb * k), generator=g, device=dev,
                       dtype=torch.int32)
    msgs = torch.randint(0, 256, (C, sign_w), generator=g, device=dev,
                         dtype=torch.uint8)
    msgs[:, 16:20] = torch.rand(C, generator=g, device=dev).view(
        torch.uint8).view(C, 4)
    msgs11 = torch.randint(0, 256, (C, topk_w), generator=g, device=dev,
                           dtype=torch.uint8)
    ops.pack_uint_rows(tot, 1, msgs, 20)
    ops.pack_uint_rows(li, ib, msgs11, 16)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)
    evict = lambda: flush.sum()
    blank, blank11 = torch.empty_like(msgs), torch.empty_like(msgs11)
    fkw = dict(scale_col=16, scale_block=0)

    # the kernels as built, held to their twins
    rows = {
        "pack n=1 fused (fp32)": (
            lambda: ops.pack_uint_rows_cuda(tot, 1, blank, 20),
            lambda: ref.pack_uint_rows(tot, 1, blank.clone(), 20)),
        "pack n=1 uint8 bits": (
            lambda: ops.pack_uint_rows_cuda(bits, 1, blank, 20),
            lambda: ref.pack_uint_rows(bits, 1, blank.clone(), 20)),
        "unpack n=1 fused (fp32)": (
            lambda: ops.unpack_uint_rows_cuda(msgs, 20, 1, d, torch.float32,
                                              **fkw),
            lambda: ref.unpack_uint_rows(msgs, 20, 1, d, torch.float32,
                                         **fkw)),
        "unpack n=1 uint8 bits": (
            lambda: ops.unpack_uint_rows_cuda(msgs, 20, 1, d, torch.uint8),
            lambda: ref.unpack_uint_rows(msgs, 20, 1, d, torch.uint8)),
        "pack n=11": (
            lambda: ops.pack_uint_rows_cuda(li, ib, blank11, 16),
            lambda: ref.pack_uint_rows(li, ib, blank11.clone(), 16)),
        "unpack n=11": (
            lambda: ops.unpack_uint_rows_cuda(msgs11, 16, ib, nb * k),
            lambda: ref.unpack_uint_rows(msgs11, 16, ib, nb * k)),
    }
    for name, (kern, twin) in rows.items():
        got = kern()
        if got is blank or got is blank11:
            got = got.clone()
        want = twin()
        torch.cuda.synchronize()
        cs.check(torch.equal(got.view(torch.uint8) if got.dtype ==
                             torch.float32 else got,
                             want.view(torch.uint8) if want.dtype ==
                             torch.float32 else want),
                 f"{name} differs from the twin")
    runs = {name: kern for name, (kern, _) in rows.items()}

    # another commit's kernels, once a row
    if len(sys.argv) > 1:
        src = Path(sys.argv[1]).resolve() / "bitpack.cu"
        lib = nvcc(src, OUT / "other" / "libbitpack.so")
        per_row = "int in_bytes" in src.read_text()
        pk, up = lib.pack_uint_launch, lib.unpack_uint_launch
        pk.restype = up.restype = ctypes.c_int
        if per_row:
            pk.argtypes, up.argtypes = ROW_PACK, ROW_UNPACK
        else:
            pk.argtypes = _build.SIGNATURES["pack_uint"]
            up.argtypes = _build.SIGNATURES["unpack_uint"]
        tag = "other, one launch a row" if per_row else "other"
        o1 = torch.empty(C, n1, dtype=torch.uint8, device=dev)
        o11 = torch.empty(C, n11, dtype=torch.uint8, device=dev)
        u1 = torch.empty(C, d, dtype=torch.uint8, device=dev)
        u11 = torch.empty(C, nb * k, dtype=torch.int32, device=dev)
        p1 = msgs[:, 20:].contiguous()
        p11 = msgs11[:, 16:16 + n11].contiguous()

        def other(fn, args_of):
            def run():
                if per_row:
                    for r in range(C):
                        launched(fn(*args_of(r), stream()), tag)
                else:
                    launched(fn(*args_of(None), stream()), tag)
            return run

        if per_row:
            pack1 = other(pk, lambda r: (bits[r].data_ptr(), o1[r].data_ptr(),
                                         d, 1, 1))
            pack11 = other(pk, lambda r: (li[r].data_ptr(),
                                          o11[r].data_ptr(), nb * k, ib, 4))
            unpack1 = other(up, lambda r: (p1[r].data_ptr(), n1,
                                           u1[r].data_ptr(), d, 1, 1))
            unpack11 = other(up, lambda r: (p11[r].data_ptr(), n11,
                                            u11[r].data_ptr(), nb * k, ib,
                                            4))
        else:
            pack1 = other(pk, lambda r: (bits.data_ptr(), d, 0,
                                         o1.data_ptr(), n1, 0, d, 1, C))
            pack11 = other(pk, lambda r: (li.data_ptr(), nb * k, 1,
                                          o11.data_ptr(), n11, 0, nb * k,
                                          ib, C))
            unpack1 = other(up, lambda r: (p1.data_ptr(), n1, 0, n1,
                                           u1.data_ptr(), d, 0, d, 1, C, 0,
                                           0))
            unpack11 = other(up, lambda r: (p11.data_ptr(), n11, 0, n11,
                                            u11.data_ptr(), nb * k, 1,
                                            nb * k, ib, C, 0, 0))
        for run in (pack1, pack11, unpack1, unpack11):
            run()
        torch.cuda.synchronize()
        cs.check(torch.equal(o1, p1) and torch.equal(o11, p11) and
                 torch.equal(u1, bits) and torch.equal(u11, li),
                 f"{tag}: outputs differ from the twins'")
        runs.update({f"pack n=1 uint8 bits [{tag}]": pack1,
                     f"unpack n=1 uint8 bits [{tag}]": unpack1,
                     f"pack n=11 [{tag}]": pack11,
                     f"unpack n=11 [{tag}]": unpack11})

    # the load/store floor of each pair's bytes, and one empty launch
    (OUT / "floor").mkdir(parents=True, exist_ok=True)
    (OUT / "floor" / "floor.cu").write_text(FLOOR_CU)
    flib = nvcc(OUT / "floor" / "floor.cu", OUT / "floor" / "libfloor.so")
    flib.floor_launch.argtypes = [_P, _LL, _P, _LL, _I, _P]
    flib.empty_launch.argtypes = [_P]
    flib.floor_launch.restype = flib.empty_launch.restype = ctypes.c_int
    scratch = torch.empty(C * 4 * d // 16 + 64, 4, dtype=torch.int32,
                          device=dev)

    def floor(n_in_bytes, n_out_bytes, src):
        n_in, n_out = -(-n_in_bytes // 16), -(-n_out_bytes // 16)
        r = -(-n_in // n_out) if n_in >= n_out else -(-(-n_out // n_in))
        return lambda: launched(flib.floor_launch(
            src.data_ptr(), n_in, scratch.data_ptr(), n_out, r, stream()),
            "floor")

    runs.update({
        "floor: fp32 totals -> sign bits": floor(4 * C * d, C * n1, tot),
        "floor: sign bits -> fp32": floor(C * n1, 4 * C * d, msgs),
        "floor: n=11 offsets -> bytes": floor(4 * C * nb * k, C * n11, li),
        "floor: n=11 bytes -> offsets": floor(C * n11, 4 * C * nb * k,
                                              msgs11),
        "empty launch": lambda: launched(flib.empty_launch(stream()),
                                         "empty"),
    })
    res = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            res[name].append(cs.time_ms(runs[name], evict))
    bounds = {"pack n=1 fused (fp32)": 4 * C * d + C * n1,
              "unpack n=1 fused (fp32)": 4 * C * d + C * n1 + 4 * C,
              "pack n=1 uint8 bits": C * d + C * n1,
              "unpack n=1 uint8 bits": C * d + C * n1,
              "pack n=11": 4 * C * nb * k + C * n11,
              "unpack n=11": 4 * C * nb * k + C * n11}
    print("µs (in order, reversed); bound = bytes / "
          f"{cs.PEAK_BYTES_S / 1e12} TB/s")
    for name, t in res.items():
        b = bounds.get(name)
        tail = f"   bound {b / cs.PEAK_BYTES_S * 1e6:6.2f}" if b else ""
        print(f"{name:<44} {t[0] * 1e3:>8.2f} {t[1] * 1e3:>8.2f}"
              f"{tail}")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "pack_floor.json").write_text(json.dumps(
        {"card": card, "ms": res, "bound_bytes": bounds,
         "shapes": f"{C} rows; sign: ({C},{d}) fp32 <-> ({C},{sign_w}) "
                   f"messages at column 20; n=11: ({C},{nb * k}) int32 <-> "
                   f"({C},{topk_w}) messages at column 16"}, indent=1))


if __name__ == "__main__":
    main()
