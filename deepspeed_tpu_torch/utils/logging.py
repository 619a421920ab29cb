"""Logging utilities.

Counterpart of ``deepspeed_tpu/utils/logging.py``: a package logger plus
rank-aware helpers (``log_dist``).  The rank is the ``torch.distributed``
rank when a process group is up, else 0.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: str = LOG_LEVEL) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(getattr(logging, level, logging.INFO))
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0)."""
    ranks = ranks if ranks is not None else [0]
    me = _process_index()
    if -1 in ranks or me in ranks:
        logger.log(level, message)


def warning_once(message: str) -> None:
    _warn_once(message)


@functools.lru_cache(None)
def _warn_once(message: str) -> None:
    logger.warning(message)
