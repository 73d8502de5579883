"""Elasticity CLI (JAX ``bin/dstpu_elastic``): inspect a config's elastic
schedule or supervise a worker command under the elastic agent.

  python -m deepspeed_tpu_torch.elasticity info --config ds_config.json
  python -m deepspeed_tpu_torch.elasticity run  --config ds_config.json --world 8 -- python train.py
"""
import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info", help="show valid world sizes / batch candidates")
    pi.add_argument("--config", required=True)
    pr = sub.add_parser("run", help="supervise a worker command with restarts/rescale")
    pr.add_argument("--config", required=True)
    pr.add_argument("--world", type=int, required=True)
    pr.add_argument("--max-restarts", type=int, default=3)
    pr.add_argument("worker_cmd", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    with open(args.config) as fh:
        cfg = json.load(fh)
    elastic = cfg.get("elasticity")
    if not elastic:
        print("config has no 'elasticity' section", file=sys.stderr)
        return 1

    if args.cmd == "info":
        from . import compute_elastic_config
        batch, valid = compute_elastic_config(cfg)
        print(json.dumps({"final_batch_size": batch, "valid_gpus": valid}, indent=1))
        return 0

    worker = list(args.worker_cmd)
    if worker and worker[0] == "--":  # strip only the leading separator:
        worker = worker[1:]           # an inner '--' belongs to the worker's argv
    if not worker:
        print("no worker command given after '--'", file=sys.stderr)
        return 1
    from . import DSElasticAgent
    agent = DSElasticAgent(worker, world_size=args.world, elastic_config=elastic,
                           max_restarts=args.max_restarts)
    return agent.run()


if __name__ == "__main__":
    sys.exit(main())
