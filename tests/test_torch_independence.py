"""The port stands alone: importing ``deepspeed_tpu_torch`` (every submodule)
and ``chip_smoke`` pulls in neither ``jax`` nor ``deepspeed_tpu``, and the
port's source spells no such import."""

import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deepspeed_tpu_torch"

PROBE = r"""
import importlib, json, pkgutil, sys
import deepspeed_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(deepspeed_tpu_torch.__path__,
                                              "deepspeed_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke  # guarded by __main__: importing it runs nothing
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib", "deepspeed_tpu."))
                or m == "deepspeed_tpu")
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    for expected in ("deepspeed_tpu_torch.ops.attention.paged",
                     "deepspeed_tpu_torch.models.mistral",
                     "deepspeed_tpu_torch.inference.v2.engine_v2",
                     "deepspeed_tpu_torch.ops.attention.flash",
                     "deepspeed_tpu_torch.ops.adam.fused_adam",
                     "deepspeed_tpu_torch.runtime.engine",
                     "deepspeed_tpu_torch.ops.sparse_attention.attention",
                     "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config",
                     "deepspeed_tpu_torch.ops.adam.adam8bit",
                     "deepspeed_tpu_torch.ops.quantizer.quantize",
                     "deepspeed_tpu_torch.inference.quantization",
                     "deepspeed_tpu_torch.inference.engine"):
        assert expected in report["modules"]


def test_port_source_spells_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+(jax|jaxlib|deepspeed_tpu)\b|"
                         r"from\s+(jax|jaxlib|deepspeed_tpu)(\.|\s))", re.MULTILINE)
    files = [f for f in sorted(PACKAGE.rglob("*.py"))
             if "build" not in f.relative_to(PACKAGE).parts]  # kernel build outputs
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
