"""Logging, seeding and the write gate of data parallel (reference
lib/helpers/utils_helper.py parity; monodetr_tpu/utils/misc.py with
torch.distributed's rank where the JAX package asks for its process
index)."""

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


def is_main_process():
    """The rank that writes checkpoints and result txts and evaluates
    (reference is_main_process / save_on_master, utils/misc.py:381-407):
    rank 0 of an initialised torch.distributed process group, or True
    when there is none."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def set_random_seed(seed):
    """Seeds python/numpy (utils_helper.py:18-26)."""
    random.seed(seed)
    np.random.seed(seed)
