"""Logging + seeding (reference lib/helpers/utils_helper.py parity).

A copy of the JAX package's utils/misc.py without its multi-host write
gate, which asks JAX for the process index."""

import logging
import random

import numpy as np


def create_logger(log_file, rank=0):
    log_format = "%(asctime)s  %(levelname)5s  %(message)s"
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format=log_format,
        filename=log_file,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    console.setFormatter(logging.Formatter(log_format))
    logging.getLogger(__name__).addHandler(console)
    return logging.getLogger(__name__)


def set_random_seed(seed):
    """Seeds python/numpy (utils_helper.py:18-26)."""
    random.seed(seed)
    np.random.seed(seed)
