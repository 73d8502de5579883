"""Autotune an engine config (JAX ``bin/dstpu_autotune``).

Usage: python -m deepspeed_tpu_torch.autotuning --config ds_config.json --entry pkg.module:make

``make()`` must return (loss_fn, params, example_batch_fn, model_info) where
example_batch_fn(train_batch_size) -> batch and model_info is
autotuning.ModelInfo.  Writes results_dir/dstpu_config_optimal.json.  The
experiments run on one GPU (``--device``, default cuda), data-parallel
size 1.
"""
import argparse
import importlib
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True, help="base JSON config (with optional autotuning section)")
    p.add_argument("--entry", required=True, help="pkg.module:fn returning (loss_fn, params, batch_fn, model_info)")
    p.add_argument("--device", default="cuda", help="the device the experiments train on")
    args = p.parse_args(argv)

    mod_name, _, fn_name = args.entry.partition(":")
    make = getattr(importlib.import_module(mod_name), fn_name or "make")
    loss_fn, params, batch_fn, model_info = make()

    with open(args.config) as fh:
        user_config = json.load(fh)

    at_section = user_config.get("autotuning") or {}
    if at_section.get("enabled") is False:
        print("autotuning: disabled in config (autotuning.enabled = false)")
        return 0

    from . import Autotuner, AutotuningConfig
    from .autotuner import make_engine_runner

    at_cfg = AutotuningConfig(**at_section)
    runner = make_engine_runner(loss_fn, params, example_batch_fn=batch_fn,
                                autotuning_config=at_cfg, device=args.device)
    tuner = Autotuner(model_info, runner, user_config=user_config, dp_size=1, config=at_cfg)
    best = tuner.tune()
    path = tuner.write_results()
    if best is None:
        print("autotuning: no feasible configuration found", file=sys.stderr)
        return 1
    print(f"autotuning: best config written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
