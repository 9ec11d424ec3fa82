"""Build and load the port's CUDA kernels.

Every ``vtpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into an object (one ``nvcc`` per source, all started together), and the
objects are linked into one shared library with a plain C interface.
The library lands in ``vtpu_torch/_build/`` (git-ignored) under a name
keyed by a hash of the sources and flags, so the first call after a
source change rebuilds and every later call reuses it.  It is loaded
with ``ctypes``; each C entry takes pointers and the stream as
``c_void_p`` and returns ``cudaGetLastError()``, which :func:`check`
turns into an exception.

Nothing here runs at import time: the kernels are built at first use,
inside the wrapper that launches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry: (argtypes); all return int (cudaError_t)
SIGNATURES = {
    # x, gamma, beta, y, rows, d, eps, stream
    "vtpu_layernorm_f32_f32": (P, P, P, P, I, I, F, P),
    "vtpu_layernorm_bf16_bf16": (P, P, P, P, I, I, F, P),
    # q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, scratch,
    # b, n_heads, n_kv, hd, bs, nb_max, sm_scale, stream
    **{f"vtpu_paged_decode_{v}": (P,) * 9 + (I,) * 6 + (F, P)
       for v in ("f32", "bf16", "q8_f32", "q8_bf16")},
    # q, k, v, o, lse, n_q, g, seq_q, seq_k, hd, causal, shift, window,
    # sm_scale, stream
    # (the _wide entries: the same for 128 < hd <= 512)
    **{f"vtpu_flash_fwd_{w}{v}": (P,) * 5 + (I,) * 8 + (F, P)
       for w in ("", "wide_") for v in ("f32", "bf16", "bf16_f32out")},
    # q, k, v, do, lse, delta, dq, n_q, ... (as above)
    **{f"vtpu_flash_bwd_dq_{w}{v}": (P,) * 7 + (I,) * 8 + (F, P)
       for w in ("", "wide_") for v in ("f32", "bf16")},
    # q, k, v, do, lse, delta, dk, dv, n_q, ... (as above)
    **{f"vtpu_flash_bwd_dkv_{w}{v}": (P,) * 8 + (I,) * 8 + (F, P)
       for w in ("", "wide_") for v in ("f32", "bf16")},
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = ""        # ptxas register/shared-memory report of that build


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "vtpu_torch: nvcc not found (set CUDA_HOME); the CUDA kernels are "
        "built from vtpu_torch/csrc at first use"
    )


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(so_path: str, srcs) -> None:
    global build_seconds, build_log
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = f"{so_path}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    units = [s for s in srcs if s.endswith(".cu")]
    procs = []
    for src in units:
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", os.path.join(tmp, "lib.so"),
         *[obj for _s, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(os.path.join(tmp, "lib.so"), so_path)
    shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call if its hash is new."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = _sources()
            os.makedirs(BUILD_DIR, exist_ok=True)
            so_path = os.path.join(
                BUILD_DIR, f"libvtpu_kernels_{_digest(srcs)}.so")
            if not os.path.exists(so_path):
                _build(so_path, srcs)
            handle = ctypes.CDLL(so_path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.vtpu_paged_decode_scratch.argtypes = [I] * 6
            handle.vtpu_paged_decode_scratch.restype = ctypes.c_longlong
            handle.vtpu_error_string.argtypes = [ctypes.c_int]
            handle.vtpu_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (refused launch: too many
    threads, too much shared memory, bad arguments)."""
    if err != 0:
        msg = _lib.vtpu_error_string(err).decode() if _lib else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
