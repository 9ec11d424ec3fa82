"""Build the CUDA driver-API interposer and its test doubles with ``g++``.

Every artifact is built from the sources beside this file at first use,
never at import time:

- ``libvgpu_interpose.so``: the interposer (``vgpu_interpose.cc`` over
  the port's copy of the shared-region writer), loaded by a tenant with
  ``LD_PRELOAD``;
- ``vgpu_hook_bench``: what the interposer adds to a launch and to an
  allocation (``hook_bench.cc``);
- ``mock/libcuda.so.1`` and ``mock/libnvidia-ml.so.1``: the mock driver
  libraries of the CPU tests, put first on ``LD_LIBRARY_PATH``.

No CUDA header or library takes part: ``cuda_min.h`` declares what the
interposer uses, so one source builds here and on a machine with a card.
The build goes into ``vtpu_torch/_build/native-<hash>/`` (git-ignored),
the hash taken over the sources and the flags.  Several processes may
ask at once (the tests' workers): one builds under a file lock into a
scratch directory and moves it into place with ``os.replace``; the
others wait on the lock and find it built.  The targets are compiled one
after another, so that a build takes one core from whatever runs beside
it.  A failed build raises.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
FLAGS = ["-std=c++17", "-O2", "-fPIC", "-fvisibility=hidden", "-Wall"]
LIBS = ["-ldl", "-lpthread"]
# artifact -> (sources, shared library or executable)
TARGETS = {
    "libvgpu_interpose.so": (["vgpu_interpose.cc", "shared_region.cc"], True),
    "vgpu_hook_bench": (["hook_bench.cc"], False),
    "mock/libcuda.so.1": (["mock_cuda.cc"], True),
    "mock/libnvidia-ml.so.1": (["mock_nvml.cc"], True),
}


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("vtpu_torch.native: g++ not found; the "
                           "interposer is built from vtpu_torch/native")
    return gxx


def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    for name in sorted(os.listdir(HERE)):
        if name.endswith((".cc", ".h")):
            h.update(name.encode())
            with open(os.path.join(HERE, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _compile(gxx: str, out_dir: str, target: str) -> None:
    sources, shared = TARGETS[target]
    out = os.path.join(out_dir, target)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [gxx, *FLAGS, *(["-shared"] if shared else []), "-o", out,
           *[os.path.join(HERE, s) for s in sources], *LIBS]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"vtpu_torch.native: building {target} failed:\n"
                           f"{' '.join(cmd)}\n{res.stderr[-4000:]}")


def build() -> str:
    """The directory holding every artifact of ``TARGETS``, built now if
    this source tree has not been built yet."""
    out_dir = os.path.join(BUILD_DIR, f"native-{_key()}")
    if os.path.isdir(out_dir):
        return out_dir
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out_dir + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isdir(out_dir):
            return out_dir
        gxx = _gxx()
        tmp = f"{out_dir}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            for target in TARGETS:
                _compile(gxx, tmp, target)
            os.replace(tmp, out_dir)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out_dir


def interposer() -> str:
    """The path of ``libvgpu_interpose.so``, for ``LD_PRELOAD``."""
    return os.path.join(build(), "libvgpu_interpose.so")


def hook_bench() -> str:
    return os.path.join(build(), "vgpu_hook_bench")


def mock_dir() -> str:
    """The directory of the mock ``libcuda.so.1`` and
    ``libnvidia-ml.so.1``, for ``LD_LIBRARY_PATH``."""
    return os.path.join(build(), "mock")
