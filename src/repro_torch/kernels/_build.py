"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (H100), and the objects are linked into one shared library
with a plain C interface, ``build/repro_torch/libreprokernels.so`` under the
repository root. ``ctypes`` loads it; every pointer and the CUDA stream pass
as ``c_void_p``. The library is rebuilt when the hash of the sources or the
flags changes, and is built on first use only, never at import: a machine
without ``nvcc`` can import every module of the port.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("adc_scan.cu", "gcd_score.cu", "givens_rotate.cu", "pq_assign.cu",
           "embedding_bag.cu", "fused_lut.cu")
HEADERS = ("cp_async.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libreprokernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUDA_ROOTS = ("/usr/local/cuda",)   # the toolkit's default install prefix

_lib: ctypes.CDLL | None = None
#: What the last build in this process did: seconds and the compiler's
#: resource report (entry function, registers, spills) per kernel.
build_info: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or the
    toolkit's default prefix. Raises if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "repro_torch kernels: nvcc not found (PATH, CUDA_HOME, "
        "/usr/local/cuda); the CUDA kernels build only where the toolkit is")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with the compiler's output on
    the first failure. Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"repro_torch kernels: build failed ({p.returncode}):\n"
                f"{' '.join(cmd)}\n{out}\n{err}")
    return [err for _, err in outs]


def _compile(digest: str) -> None:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / (Path(s).stem + ".o") for s in SOURCES]
    logs = _run_all([[nvcc, *FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                     for s, o in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    _run_all([[nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, BUILD_DIR / LIB_NAME)
    (BUILD_DIR / f"{LIB_NAME}.sha256").write_text(digest)
    build_info.update(seconds=time.perf_counter() - t0, built=True,
                      ptxas=[ln.strip() for log in logs
                             for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln
                             or "entry function" in ln])


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_ivf_adc.argtypes = [p, i, p, p, p, p, p, p, ll, i, i, i, i, p]
    lib.repro_ivf_adc.restype = i
    lib.repro_adc_lookup.argtypes = [p, i, p, p, p, p, i, ll, i, i, i, p]
    lib.repro_adc_lookup.restype = i
    lib.repro_gcd_score.argtypes = [p, p, p, i, i, p]
    lib.repro_gcd_score.restype = i
    lib.repro_givens_rotate.argtypes = [p, p, p, p, p, p, ll, i, i, i, p]
    lib.repro_givens_rotate.restype = i
    lib.repro_pq_assign.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i, i,
                                     p]
    lib.repro_pq_assign.restype = i
    lib.repro_embedding_bag.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.repro_embedding_bag.restype = i
    lib.repro_fused_lut.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.repro_fused_lut.restype = i
    lib.repro_adc_batch.argtypes = [p, i, p, p, p, i, i, ll, i, i, i, i, i,
                                    p]
    lib.repro_adc_batch.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    digest = _digest()
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / f"{LIB_NAME}.sha256"
    if not (so.is_file() and stamp.is_file()
            and stamp.read_text() == digest):
        _compile(digest)
    else:
        build_info.update(seconds=0.0, built=False, ptxas=[])
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"repro_torch kernels: {what} launch failed with "
                           f"cudaError {err}")
