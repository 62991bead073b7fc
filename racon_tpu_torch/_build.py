"""Builds the port's compiled parts at first use, from the sources in the
checkout, into the git-ignored `build/` directory at the repository root.

  - `kernels()`: every `csrc/*.cu` with `nvcc` for Hopper (`sm_90a`), one
    `nvcc -c` per source started together, linked into one shared
    library with a plain C interface and loaded with ctypes. Each C
    entry point returns `cudaGetLastError()` after its launch; the
    wrappers raise DeviceError on a non-zero code.
  - the C++ host library (native/) is built by native.build() into the
    same directory.

Outputs are keyed by a hash of their sources and flags, and land by an
atomic rename, so concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from .errors import DeviceError

PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = PKG.parent / "build"
CSRC = PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_kernels: ctypes.CDLL | None = None
#: what the last kernel build did: seconds, whether it compiled or found
#: a cached library, and the assembler's per-kernel report
build_info: dict = {}


def digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def install(tmp: pathlib.Path, dst: pathlib.Path) -> None:
    """Atomic publish of a freshly built file."""
    os.replace(tmp, dst)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise DeviceError("build", "nvcc not found (needs the CUDA toolkit)")


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _kernels
    with _lock:
        if _kernels is None:
            _kernels = _bind(ctypes.CDLL(str(_build_kernels())))
    return _kernels


def _build_kernels() -> pathlib.Path:
    sources = sorted(CSRC.glob("*.cu"))
    flags = NVCC_FLAGS + ("-Xptxas", "-v")
    out_dir = BUILD_DIR / "kernels"
    lib = out_dir / f"libracon_kernels-{digest(sources, flags)}.so"
    t0 = time.perf_counter()
    if lib.exists():
        build_info.update(seconds=time.perf_counter() - t0, cached=True,
                          ptxas="")
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [out_dir / f"{s.stem}-{tag}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    reports = []
    failed = []
    for s, p in zip(sources, procs):
        text, _ = p.communicate()
        reports.append(text)
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{text}")
    if failed:
        raise DeviceError("build", "nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"{lib.name}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise DeviceError("build", f"nvcc link failed:\n{link.stderr}")
    install(tmp, lib)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas="".join(reports))
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rt_poa_window_sweep.restype = i32
    lib.rt_poa_window_sweep.argtypes = [vp] * 11 + [i32] * 9 + [vp]
    lib.rt_poa_ring_rows.restype = i32
    lib.rt_poa_ring_rows.argtypes = [i32] * 5
    lib.rt_poa_fused.restype = i32
    lib.rt_poa_fused.argtypes = [vp] * 21 + [i32] * 11 + [vp]
    lib.rt_poa_fused_smem.restype = i32
    lib.rt_poa_fused_smem.argtypes = [i32] * 3
    lib.rt_poa_fused_scratch.restype = ctypes.c_longlong
    lib.rt_poa_fused_scratch.argtypes = [i32] * 3
    lib.rt_align_wavefront.restype = i32
    lib.rt_align_wavefront.argtypes = [vp] * 8 + [i32] * 6 + [vp]
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.rt_error_string.argtypes = [i32]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        msg = lib.rt_error_string(code).decode(errors="replace")
        raise DeviceError(what, f"CUDA error {code}: {msg}")
