"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) into an object,
all at once in parallel, and the objects are linked into
``build/kernels/libkpca_kernels.so`` at the repository root. The library
exposes a plain C interface (no PyTorch headers), so a full build takes
seconds. A content hash of the sources and flags sits beside the library;
the library is rebuilt whenever it no longer matches. A failed build raises,
and nothing falls back to the plain PyTorch versions.

The build runs at first use (``load_library``), never at import, so the
package imports on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libkpca_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _i, _f, _ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# C entry points (csrc/*.cu): every one returns cudaGetLastError().
SIGNATURES = {
    # x, y (NULL: y is x), scratch, gamma, out, batch, n, k, m, padded m,
    # tile rows, kind, degree, coef, scale, normalize, stream
    "kpca_gram": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f,
                  _f, _i, _p],
    # xq, support hi, support lo, shift (NULL: none), a, ss, gamma,
    # scratch, cvec, bvec, out, b, l, m, padded m, cp1, feature slices,
    # with_epilogue, inv_l, kind, degree, coef, scale, normalize, stream
    "kpca_project": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                     _i, _i, _i, _i, _f, _i, _i, _f, _f, _i, _p],
    # support rows, shift (NULL: none), hi, lo, norms, l, m, padded m,
    # kind, degree, coef, scale, normalize, stream
    "kpca_project_support": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _f,
                             _i, _p],
    # k, scratch, out, z1, z2, n, m, k's strides (s1, s2, sn, sm), rows
    # per slab (0: one launch), slabs, column tiles, vec, stream
    "kpca_center": [_p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _i,
                    _i, _i, _p],
    # v, inv, k, b, g, rho, alpha, bout, ka, j, n, s, b strides (j, n, s),
    # g strides (j, n, s), stream
    "kpca_admm_step": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                       _ll, _ll, _ll, _ll, _ll, _ll, _p],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What ``build`` did: the library path, whether it compiled (False:
    the existing library matched the sources), wall seconds, and the
    compiler's per-kernel register/shared-memory report."""

    path: Path
    compiled: bool
    seconds: float
    log: str


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def build(force: bool = False) -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``BUILD_DIR/LIB_NAME`` unless the library
    already matches the sources' hash."""
    lib_path = BUILD_DIR / LIB_NAME
    hash_path = BUILD_DIR / (LIB_NAME + ".sha256")
    want = source_hash()
    if not force and lib_path.exists() and hash_path.exists() \
            and hash_path.read_text().strip() == want:
        return BuildInfo(lib_path, False, 0.0, "")
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)        # atomic: readers never see
        hash_path.write_text(want + "\n")    # a half-written library
    return BuildInfo(lib_path, True, time.perf_counter() - t0, log)


def load_library() -> ctypes.CDLL:
    """Build if stale, load once per process, declare every signature."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


__all__ = ["BUILD_DIR", "BuildInfo", "LIB_NAME", "build", "load_library",
           "nvcc_path", "source_hash", "sources"]
