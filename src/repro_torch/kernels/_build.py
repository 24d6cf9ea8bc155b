"""Build and load the CUDA kernels in ``csrc/``.

Each kernel has a plain C entry point ``<name>_launch`` in
``csrc/<source>.cu`` (``<source>`` is the kernel's name unless
:data:`SOURCES` says otherwise: ``bitpack.cu`` holds both ``pack_uint`` and
``unpack_uint``). Each source is compiled by ``nvcc`` into its own shared
library under ``build/repro_torch/`` at the repository root, then loaded
with ``ctypes``. Nothing is built when a module is imported: the first
launch of a kernel builds all of them, one ``nvcc`` per source, started
together. A library's file name carries a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math``, and ``--fmad=false`` —
the JAX reference rounds every multiply and add separately, and a fused
multiply-add would round once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

#: kernel name → argument types of its C entry ``<name>_launch`` (pointers
#: and the stream as c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "topk_ef_sparse": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "fedams_ingest": [_P] * 14 + [_LL, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                                  _F, _F, _I, _I, _P],
    "fedams_update": [_P] * 9 + [_LL, _F, _F, _F, _F, _F, _F, _I, _P],
    "topk_ef": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "sign_ef": [_P] * 6 + [_LL, _I, _I, _P],
    "pack_uint": [_P, _LL, _I, _P, _LL, _LL, _LL, _I, _I, _P],
    "unpack_uint": [_P, _LL, _LL, _LL, _P, _LL, _I, _LL, _I, _I, _LL, _LL,
                    _P],
}

#: kernel name → the ``csrc/<source>.cu`` that holds its entry point, where
#: it is not ``<name>.cu``
SOURCES = {"pack_uint": "bitpack", "unpack_uint": "bitpack"}

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("repro_torch: nvcc not found (PATH or "
                           "/usr/local/cuda/bin) — the CUDA kernels are "
                           "built on the machine with the card")
    return path


def _source(name: str) -> str:
    return SOURCES.get(name, name)


def _lib_path(source: str) -> Path:
    h = hashlib.sha1((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all ``nvcc``
    processes at once. Returns source name → library path. The
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src: _lib_path(src)
             for src in dict.fromkeys(map(_source, SIGNATURES))}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    procs = {}
    for name, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    return paths


def kernel(name: str):
    """The ctypes entry ``<name>_launch`` (building the kernels on first
    use). It returns the launch's ``cudaGetLastError()`` as an int."""
    if not _loaded:
        libs = {src: ctypes.CDLL(str(path))
                for src, path in build_all().items()}
        for kname, argtypes in SIGNATURES.items():
            fn = getattr(libs[_source(kname)], f"{kname}_launch")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[kname] = fn
    return _loaded[name]
