"""Tolerant environment-variable number parsing.

Counterpart of ``deepspeed_tpu/utils/env.py``.  The serving supervisor
drives its workers through an env contract (``DSTPU_HEARTBEAT_INTERVAL_S``,
``DSTPU_SERVING_FSYNC_EVERY``, ...).  Every consumer wants the same
semantics: unset or empty means "use the default", garbage means "warn once
and use the default" — a malformed env var must degrade supervision, never
crash a worker.  One helper so the parse sites can't drift apart.
"""

import logging
import os
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

logger = logging.getLogger(__name__)
_warned: set = set()


def warning_once(message: str) -> None:
    """Log ``message`` as a warning the first time it is seen in this
    process (a throttled hot-loop failure must not flood the log)."""
    if message not in _warned:
        _warned.add(message)
        logger.warning(message)


def _env_number(name: str, default: Optional[T], cast: Callable[[str], T],
                warn: bool) -> Optional[T]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        if warn:
            warning_once(f"env: bad {name}={raw!r} (not a {cast.__name__}); "
                         f"using default {default!r}")
        return default


def env_float(name: str, default: Optional[float] = None,
              warn: bool = True) -> Optional[float]:
    return _env_number(name, default, float, warn)


def env_int(name: str, default: Optional[int] = None,
            warn: bool = True) -> Optional[int]:
    return _env_number(name, default, int, warn)
