"""The `--device` flag every example takes."""

import argparse
import logging

from ..workloads._common import require_device


def device_from_argv(argv, description):
    """Parse `--device` (default cuda; raises without a card) and turn on
    the package's INFO log, as the JAX examples do."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig()
    logging.getLogger("adaptaqc_tpu_torch").setLevel(logging.INFO)
    return require_device(args.device)
