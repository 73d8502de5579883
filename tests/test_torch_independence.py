"""The port stands alone: importing ``deepspeed_tpu_torch`` (every submodule)
and ``chip_smoke`` (with ``offload_probe``) pulls in neither ``jax``, ``deepspeed_tpu`` nor
``safetensors`` (absent on the card's machine), and the port's source spells
no such import."""

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
import offload_probe  # so is the offload probe
leaked = sorted(m for m in sys.modules
                if m in ("jax", "deepspeed_tpu", "safetensors")
                or m.startswith(("jax.", "jaxlib", "deepspeed_tpu.", "safetensors.")))
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
                     "deepspeed_tpu_torch.inference.engine",
                     "deepspeed_tpu_torch.inference.v2.supervisor",
                     "deepspeed_tpu_torch.inference.v2.journal",
                     "deepspeed_tpu_torch.runtime.heartbeat",
                     "deepspeed_tpu_torch.utils.wal",
                     "deepspeed_tpu_torch.utils.memory",
                     "deepspeed_tpu_torch.monitor.telemetry",
                     "deepspeed_tpu_torch.monitor.monitor",
                     "deepspeed_tpu_torch.monitor.metrics",
                     "deepspeed_tpu_torch.monitor.exposition",
                     "deepspeed_tpu_torch.monitor.ops_server",
                     "deepspeed_tpu_torch.inference.v2.qos",
                     "deepspeed_tpu_torch.inference.v2.router",
                     "deepspeed_tpu_torch.inference.v2.engine_factory",
                     "deepspeed_tpu_torch.models.qwen",
                     "deepspeed_tpu_torch.models.mixtral",
                     "deepspeed_tpu_torch.models.opt",
                     "deepspeed_tpu_torch.models.gptj",
                     "deepspeed_tpu_torch.models.phi",
                     "deepspeed_tpu_torch.models.falcon",
                     "deepspeed_tpu_torch.models.bloom",
                     "deepspeed_tpu_torch.models.gpt2",
                     "deepspeed_tpu_torch.models.bert",
                     "deepspeed_tpu_torch.moe.experts",
                     "deepspeed_tpu_torch.moe.sharded_moe",
                     "deepspeed_tpu_torch.moe.layer",
                     "deepspeed_tpu_torch.runtime.checkpointing",
                     "deepspeed_tpu_torch.runtime.checkpoint_engine",
                     "deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine",
                     "deepspeed_tpu_torch.runtime.optimizers",
                     "deepspeed_tpu_torch.utils.safetensors_io",
                     "deepspeed_tpu_torch.runtime.activation_checkpointing",
                     "deepspeed_tpu_torch.runtime.dataloader",
                     "deepspeed_tpu_torch.runtime.data_pipeline",
                     "deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler",
                     "deepspeed_tpu_torch.runtime.data_pipeline.data_analyzer",
                     "deepspeed_tpu_torch.runtime.data_pipeline.data_sampler",
                     "deepspeed_tpu_torch.runtime.data_pipeline.indexed_dataset",
                     "deepspeed_tpu_torch.runtime.data_pipeline.random_ltd",
                     "deepspeed_tpu_torch.runtime.progressive_layer_drop",
                     "deepspeed_tpu_torch.runtime.eigenvalue",
                     "deepspeed_tpu_torch.ops.adam.cpu_adam",
                     "deepspeed_tpu_torch.ops.aio",
                     "deepspeed_tpu_torch.runtime.swap_tensor",
                     "deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper",
                     "deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper",
                     "deepspeed_tpu_torch.checkpoint",
                     "deepspeed_tpu_torch.checkpoint.universal",
                     "deepspeed_tpu_torch.utils.tensor_fragment",
                     "deepspeed_tpu_torch.compression",
                     "deepspeed_tpu_torch.compression.basic_layer",
                     "deepspeed_tpu_torch.compression.compress",
                     "deepspeed_tpu_torch.runtime.hybrid_engine",
                     "deepspeed_tpu_torch.profiling",
                     "deepspeed_tpu_torch.profiling.flops_profiler",
                     "deepspeed_tpu_torch.elasticity",
                     "deepspeed_tpu_torch.elasticity.elasticity",
                     "deepspeed_tpu_torch.ops.attention.evoformer",
                     "deepspeed_tpu_torch.utils.logging",
                     "deepspeed_tpu_torch.utils.timer",
                     "deepspeed_tpu_torch.utils.comms_logging",
                     "deepspeed_tpu_torch.accelerator",
                     "deepspeed_tpu_torch.accelerator.abstract_accelerator",
                     "deepspeed_tpu_torch.accelerator.cuda_accelerator",
                     "deepspeed_tpu_torch.env_report",
                     "deepspeed_tpu_torch.autotuning",
                     "deepspeed_tpu_torch.autotuning.__main__",
                     "deepspeed_tpu_torch.autotuning.autotuner",
                     "deepspeed_tpu_torch.autotuning.config",
                     "deepspeed_tpu_torch.autotuning.tuner",
                     "deepspeed_tpu_torch.launcher",
                     "deepspeed_tpu_torch.launcher.launch",
                     "deepspeed_tpu_torch.launcher.runner",
                     "deepspeed_tpu_torch.elasticity.__main__",
                     "deepspeed_tpu_torch.elasticity.elastic_agent",
                     "deepspeed_tpu_torch.comm",
                     "deepspeed_tpu_torch.comm.comm",
                     "deepspeed_tpu_torch.comm.groups",
                     "deepspeed_tpu_torch.comm.benchmark",
                     "deepspeed_tpu_torch.parallel",
                     "deepspeed_tpu_torch.parallel.mesh"):
        assert expected in report["modules"]


def test_port_source_spells_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+(jax|jaxlib|deepspeed_tpu|safetensors)\b|"
                         r"from\s+(jax|jaxlib|deepspeed_tpu|safetensors)(\.|\s))", re.MULTILINE)
    files = [f for f in sorted(PACKAGE.rglob("*.py"))
             if "build" not in f.relative_to(PACKAGE).parts]  # kernel build outputs
    files += [ROOT / "chip_smoke.py", ROOT / "offload_probe.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
