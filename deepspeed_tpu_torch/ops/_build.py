"""Build and load the hand-written CUDA kernels in ``deepspeed_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``deepspeed_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with
``ctypes``; callers declare ``argtypes`` on the functions they bind.  The
library's file name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale build is never
loaded.  A source listed in ``SPLIT_SOURCES`` compiles as several
translation units at once (one ``nvcc -c`` each), linked into its one
library: the paged source's kernel instances, and the flash source's by head
dim, would otherwise build one after another.  Nothing is compiled when a
module is imported: the CPU-only test box has no ``nvcc``.

Host libraries are built the same way: a ``csrc/<name>.cpp`` (plain C
interface, no CUDA) compiles with ``g++`` and the JAX package's flags
(``HOST_FLAGS``: ``-O3 -shared -fPIC -std=c++17 -march=native -fopenmp``)
into the same directory, named by a hash of its source, those flags and the
host CPU's model and feature flags (``-march=native`` code runs on that CPU
alone), and ``load(name)`` returns it.  A machine without ``g++`` raises
:class:`KernelBuildError`, as one without ``nvcc`` does for a kernel.
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
# sources built as several translation units at once, one nvcc each with
# -D<macro>=<part>, linked into the one library: name -> (macro, parts)
SPLIT_SOURCES = {"paged_attention": ("PAGED_PART", 7), "flash_attention": ("FLASH_PART", 5)}
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native", "-fopenmp")

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


def is_host(name: str) -> bool:
    """Whether ``name`` is a host library (``csrc/<name>.cpp``, built by g++)."""
    return (CSRC_DIR / f"{name}.cpp").exists()


def _host_cpu() -> bytes:
    """The CPU's model and feature flags: ``-march=native`` builds for this
    CPU alone, so a build directory copied to another host rebuilds."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = [line for line in fh if line.startswith((b"model name", b"flags"))]
    except OSError:
        return b""
    return b"".join(sorted(set(lines)))


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags; of ``csrc/<name>.cpp``,
    by a hash of its source and ``HOST_FLAGS``."""
    if is_host(name):
        digest = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes()
                                + " ".join(HOST_FLAGS).encode() + _host_cpu()).hexdigest()
        return BUILD_DIR / f"lib{name}.{digest[:16]}.so"
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh"))]
    flags = " ".join(NVCC_FLAGS) + str(SPLIT_SOURCES.get(name))
    digest = hashlib.sha256(b"".join(parts) + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) unless a build of this exact
    source exists."""
    out = library_path(name)
    if out.exists():
        return out
    if is_host(name):
        return _build_host(name, out)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = str(CSRC_DIR / f"{name}.cu")
    t0 = time.perf_counter()
    if name in SPLIT_SOURCES:
        macro, n_parts = SPLIT_SOURCES[name]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [tmp.with_suffix(f".part{i}.o") for i in range(n_parts)]
        cmds = [[nvcc, *compile_flags, f"-D{macro}={i}", "-Xptxas", "-v", "-c", "-o", str(obj),
                 src] for i, obj in enumerate(objs)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=n_parts) as pool:
            procs = list(pool.map(_run, cmds))
        if all(proc.returncode == 0 for proc in procs):
            cmds.append([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)])
            procs.append(_run(cmds[-1]))
        for obj in objs:
            obj.unlink(missing_ok=True)
    else:
        cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), src]]
        procs = [_run(cmds[0])]
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = "".join(proc.stdout + proc.stderr for proc in procs)
    for cmd, proc in zip(cmds, procs):
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout + proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole library or none
    return out


def _build_host(name: str, out: Path) -> Path:
    """``g++`` on ``csrc/<name>.cpp`` into ``out``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise KernelBuildError(f"g++ not found on PATH: the host library csrc/{name}.cpp needs "
                               f"a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *HOST_FLAGS, str(CSRC_DIR / f"{name}.cpp"), "-o", str(tmp), "-lpthread"]
    t0 = time.perf_counter()
    proc = _run(cmd)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"g++ failed on csrc/{name}.cpp (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout + proc.stderr}")
    os.replace(tmp, out)
    return out


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build_all(names) -> None:
    """Build several kernel sources at once, one nvcc process each (one a
    part for a split source), all started together; raises the first
    failure after every build ended."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = [pool.submit(build, name) for name in names]
    for future in futures:
        future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
