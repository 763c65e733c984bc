"""The ``edl-torch`` CLI entry point (port of
elasticdl_tpu/client/main.py): ``zoo init|build|push`` and
``train|evaluate|predict|serve``.

    edl-torch train --job_name=j --image_name=IMG --model_zoo=ZOO \
        --training_data=DIR [--num_workers=N --num_ps_pods=M] [--dry_run]

or ``python -m elasticdl_tpu_torch.client.main train ...``.
"""

import argparse
import sys

from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import args as client_args


def build_parser():
    parser = argparse.ArgumentParser(
        "edl-torch", description="elasticdl_tpu_torch client"
    )
    subparsers = parser.add_subparsers(dest="command", required=True)

    zoo = subparsers.add_parser("zoo", help="model zoo image workflow")
    zoo_sub = zoo.add_subparsers(dest="zoo_command", required=True)
    p = zoo_sub.add_parser("init")
    client_args.add_zoo_init_arguments(p)
    p.set_defaults(func=api.init_zoo)
    p = zoo_sub.add_parser("build")
    client_args.add_zoo_build_arguments(p)
    p.set_defaults(func=api.build_zoo)
    p = zoo_sub.add_parser("push")
    client_args.add_zoo_push_arguments(p)
    p.set_defaults(func=api.push_zoo)

    p = subparsers.add_parser("train")
    client_args.add_common_arguments(p)
    client_args.add_train_arguments(p)
    p.set_defaults(func=api.train)

    p = subparsers.add_parser("evaluate")
    client_args.add_common_arguments(p)
    client_args.add_evaluate_arguments(p)
    p.set_defaults(func=api.evaluate)

    p = subparsers.add_parser(
        "predict",
        help="batch prediction job, or --serving_addr for online "
        "predictions against a live serving role",
    )
    client_args.add_common_arguments(p)
    client_args.add_predict_arguments(p)
    p.set_defaults(func=api.predict)

    p = subparsers.add_parser(
        "serve",
        help="long-running online serving role over a train export "
        "(micro-batched Predict RPC, zero-downtime version swap; "
        "docs/SERVING.md)",
    )
    client_args.add_common_arguments(p)
    client_args.add_serve_arguments(p)
    p.set_defaults(func=api.serve)

    return parser


def main(argv=None):
    parsed = build_parser().parse_args(argv)
    return parsed.func(parsed)


def cli(argv=None):
    """Process entry point: command handlers return their result object
    (tests consume it — e.g. the dry-run manifest), which must NOT
    become the exit code (sys.exit(dict) exits 1)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
