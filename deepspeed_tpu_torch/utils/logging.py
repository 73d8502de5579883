"""Rank-aware logging (JAX ``deepspeed_tpu/utils/logging.py``).

The package logger ``deepspeed_tpu_torch`` carries the handler: each
module's ``logging.getLogger(__name__)`` is a child of it and reaches that
handler.  ``log_dist`` filters by the process's rank, read from ``RANK``
(what the launcher and the elastic agent export), or from a provider set
with ``set_rank_provider``.

One difference from the JAX logger: this one propagates, so an
application's root handlers and pytest's ``caplog`` see its records.
"""

import logging
import os
import sys

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class _NoDuplicateFilter(logging.Filter):
    """Drop a repeat of a record logged with ``extra={"once": True}``."""

    def __init__(self):
        super().__init__()
        self._seen = set()

    def filter(self, record):
        if getattr(record, "once", False):
            key = (record.levelno, record.getMessage())
            if key in self._seen:
                return False
            self._seen.add(key)
        return True


def _create_logger(name="deepspeed_tpu_torch", level=None):
    logger_ = logging.getLogger(name)
    if logger_.handlers:
        return logger_
    level = level if level is not None else log_levels.get(LOG_LEVEL.lower(), logging.INFO)
    logger_.setLevel(level)
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        ))
    logger_.addHandler(handler)
    logger_.addFilter(_NoDuplicateFilter())
    return logger_


logger = _create_logger()


def _env_rank():
    return int(os.environ.get("RANK", "0"))


_rank_provider = _env_rank


def set_rank_provider(fn):
    global _rank_provider
    _rank_provider = fn


def _process_index():
    try:
        return _rank_provider()
    except Exception:  # a bad provider or RANK value logs as rank 0, as in JAX
        return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given ranks (None or [-1]: all)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message):
    logger.warning(message, extra={"once": True})


def print_rank_0(message):
    if _process_index() == 0:
        logger.info(message)
