"""Environment report (JAX ``deepspeed_tpu/env_report.py``), run as
``python -m deepspeed_tpu_torch.env_report``: one row for each library
that ``ops/_build.py`` builds (the CUDA kernels and the host libraries),
saying whether it is built and loads; the versions of torch, CUDA, nvcc,
numpy, scipy and einops; the device's name and count.  A row that reads
``[NO]`` is a report: nothing falls back.
"""

import importlib
import platform
import subprocess
import sys

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[91m[NO]\033[0m"


def _try_version(mod: str) -> str:
    try:
        m = importlib.import_module(mod)
        return getattr(m, "__version__", "unknown")
    except Exception:  # a report row: anything that stops the import reads "not installed"
        return "not installed"


def op_report() -> list:
    """(library, compatible, built and loaded, error) for each library."""
    from .ops import _build
    rows = []
    for name in _build.library_names():
        builder = _build.builder_class(name)()
        compatible = builder.is_compatible()
        built, error = False, ""
        if compatible:
            try:
                builder.load()
                built = True
            except Exception as exc:  # the row says why; the report goes on
                error = f"{type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''}"
        rows.append((name, compatible, built, error))
    return rows


def nvcc_version() -> str:
    from .ops._build import KernelBuildError, find_nvcc
    try:
        out = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (KernelBuildError, OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    release = [line for line in out.splitlines() if "release" in line]
    return release[0].strip() if release else out.strip()


def main(argv=None):
    import torch

    import deepspeed_tpu_torch
    from .accelerator import get_accelerator
    print("-" * 70)
    print("DeepSpeed-TPU (PyTorch/CUDA port) CUDA/C++ op report")
    print("-" * 70)
    for name, compatible, built, error in op_report():
        mark = GREEN_OK if built else RED_NO
        print(f"{name:<24} compatible={str(compatible):<6} built ... {mark}"
              + (f" ({error})" if error else ""))
    print("-" * 70)
    print("General environment:")
    print(f"  python ................ {platform.python_version()}")
    print(f"  platform .............. {platform.platform()}")
    print(f"  deepspeed_tpu_torch ... {deepspeed_tpu_torch.__version__}")
    print(f"  torch ................. {torch.__version__}")
    print(f"  torch.version.cuda .... {torch.version.cuda}")
    print(f"  nvcc .................. {nvcc_version()}")
    for mod in ("numpy", "scipy", "einops"):
        print(f"  {mod:<20} {_try_version(mod)}")
    try:
        acc = get_accelerator()
        print(f"  devices ............... {acc.device_count()} x "
              f"{acc.get_device_properties(0)['name']}")
    except RuntimeError as exc:
        print(f"  devices ............... unavailable ({exc})")
    print("-" * 70)
    return 0


if __name__ == "__main__":
    sys.exit(main())
