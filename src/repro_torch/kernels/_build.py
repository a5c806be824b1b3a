"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, never at import (CPU-only hosts import every module with no
``nvcc``), and is cached by a hash of the sources and flags under
``build/kernels/`` at the checkout's root.  ``build_all`` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mach_decode", "mach_topk", "mach_candidates",
           "mach_fused_xent_dense", "mach_fused_xent_ell",
           "mach_fused_xent_gather", "lru_scan", "flash_attention",
           "mach_xent", "lru_scan_bwd", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each library's launch functions (pointers and the
# stream as c_void_p, so none is cut to 32 bits)
SIGNATURES = {
    "mach_decode": {
        "mach_top1_launch":
            [_P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]},
    "mach_topk": {
        "mach_topk_launch":
            [_P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _P, _P, _P, _P, _P, _P]},
    "mach_candidates": {
        "bucket_topm_launch": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        "mach_candidate_topk_launch":
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I,
             _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]},
    "mach_fused_xent_dense": {
        "fused_xent_dense_fwd_launch":
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "fused_xent_dense_bwd_launch":
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
             _P, _P]},
    "mach_fused_xent_ell": {
        "fused_xent_ell_fwd_launch":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "fused_xent_ell_dlogits_launch":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
        "fused_xent_ell_dw_launch":
            [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]},
    "mach_fused_xent_gather": {
        "fused_xent_gather_fwd_launch":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "fused_xent_gather_dlogits_launch":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "fused_xent_gather_order_launch":
            [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "fused_xent_gather_dw_launch":
            [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]},
    "lru_scan": {
        "lru_scan_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
    "flash_attention": {
        "flash_attention_launch":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]},
    "mach_xent": {
        "mach_xent_fwd_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
        "mach_xent_bwd_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "lru_scan_bwd": {
        "lru_scan_bwd_launch":
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
    "flash_attention_bwd": {
        "flash_attention_bwd_launch":
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _F, _I, _I, _I, _P]},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` into a temporary file; None if the
    library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)         # atomic: concurrent builds agree
    Path(f"{out}.log").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel library not yet built, one ``nvcc`` each, all
    started together.  Returns the compiler output (``-Xptxas -v``
    register and shared-memory report) per library built."""
    jobs = {name: _start(name) for name in SOURCES}
    logs = {}
    try:
        for name, job in jobs.items():
            if job is not None:
                logs[name] = _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``) of ``name``'s built library,
    or "" if it was built by an older checkout."""
    path = Path(f"{library_path(name)}.log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with its
    launch functions' argument types declared."""
    if name not in _loaded:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mach_error_string.argtypes = [ctypes.c_int]
        lib.mach_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.mach_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
