"""Build-at-first-use for the port's native code.

Two kinds of native code live in the package, both built into the
package's `_build/` directory (ignored by git) and rebuilt whenever a
source is newer than its library:

  * the CUDA kernels (`csrc/*.cu`): nvcc for sm_90a, one process per
    source started together, linked into one shared library with a
    plain C interface that the ops modules load with ctypes. A failed
    build raises — the device path has no fallback.
  * the host helpers (`native/*.cpp`: WAL engine, batch image decode,
    text signatures, BM25): g++, as ucfp_tpu/native builds them, from
    the sources in the package alone (native/xxhash.h included). A failed host build returns
    None and the caller keeps its pure-Python path (same bytes on disk
    and on the wire, so nothing device-side is hidden by it).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
KERNEL_LIB = os.path.join(BUILD_DIR, "libucfp_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_kernels: ctypes.CDLL | None = None
#: what the last kernel build did: seconds taken (0.0 when the library
#: was already current) and the compiler's -Xptxas -v report
build_info: dict = {"seconds": 0.0, "log": ""}


def _stale(out: str, srcs: list[str]) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(s) > t for s in srcs)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate(timeout=900)
        logs.append(out)
        if p.returncode != 0:
            failed.append((c, out))
    if failed:
        c, out = failed[0]
        raise RuntimeError(f"kernel build failed: {' '.join(c)}\n{out}")
    return "".join(logs)


def build_kernels() -> str:
    """Compile csrc/*.cu into KERNEL_LIB when missing or stale; returns
    the library path. Raises RuntimeError when the toolkit is missing or
    a source does not compile."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    with _lock:
        if not _stale(KERNEL_LIB, srcs + headers):
            build_info.update(seconds=0.0)
            return KERNEL_LIB
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        tag = f"{os.getpid()}.{threading.get_ident()}"
        objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
                for s in srcs]
        try:
            log = _run_all([
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", s, "-o", o]
                for s, o in zip(srcs, objs)
            ])
            tmp = f"{KERNEL_LIB}.{tag}.tmp"
            log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
            os.replace(tmp, KERNEL_LIB)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.unlink(o)
        build_info.update(seconds=time.perf_counter() - t0, log=log)
        return KERNEL_LIB


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _kernels
    if _kernels is None:
        path = build_kernels()
        with _lock:
            if _kernels is None:
                _kernels = ctypes.CDLL(path)
    return _kernels


def build_host(src_name: str, lib_name: str,
               headers: tuple[str, ...] = ()) -> str | None:
    """g++ build of native/<src_name> into _build/<lib_name>, rebuilt
    when the source or one of the native/ `headers` it includes is newer;
    None when the toolchain is unavailable (callers keep their Python
    path)."""
    native = os.path.join(PKG_DIR, "native")
    src = os.path.join(native, src_name)
    out = os.path.join(BUILD_DIR, lib_name)
    deps = [src] + [os.path.join(native, h) for h in headers]
    with _lock:
        if not _stale(out, deps):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        # the reference build's flags: AVX2 baseline first, generic -O2
        # for toolchains that refuse it; -ffp-contract=off keeps float
        # results equal to the Python paths
        for opt in (["-O3", "-march=x86-64-v3", "-ffp-contract=off"], ["-O2"]):
            try:
                subprocess.run(
                    ["g++", *opt, "-std=c++17", "-pthread", "-fPIC", "-shared",
                     f"-I{native}", "-o", tmp, src],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, out)
                return out
            except (subprocess.CalledProcessError, FileNotFoundError, OSError,
                    subprocess.TimeoutExpired):
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return None
