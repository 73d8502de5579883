"""Build and load the hand-written CUDA kernels in ``deepspeed_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``deepspeed_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with
``ctypes``; callers declare ``argtypes`` on the functions they bind.  The
library's file name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale build is never
loaded.  Nothing is compiled when a module is imported: the CPU-only test box
has no ``nvcc``.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # kernel name -> seconds nvcc took in this process
build_log: Dict[str, str] = {}        # kernel name -> nvcc's output (ptxas resource usage)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source; the message carries its output."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(DEFAULT_NVCC):
        nvcc = DEFAULT_NVCC
    if nvcc is None:
        raise KernelBuildError("nvcc not found on PATH or at /usr/local/cuda/bin: the CUDA "
                               "kernels build only on a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log[name]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole library or none
    return out


def build_all(names) -> None:
    """Build several kernel sources at once, one nvcc process each, all
    started together; raises the first failure after every build ended."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = [pool.submit(build, name) for name in names]
    for future in futures:
        future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
