"""Framework logger with log-once semantics.

The reference routes all engine messages through a global logger whose
DuplicateFilter drops repeats flagged ``extra={"log_once": True}``
(metadrive/engine/logger.py). This package keeps the same surface —
``get_logger()`` + ``log_once`` — because a vectorized env emits the same
host-side notice for thousands of rows at once; once is enough.

    from benchmarks.reference.core.logger import get_logger
    logger = get_logger()
    logger.info("compiled %d scenes", n)
    logger.warning("expert weights zero-initialized", extra={"log_once": True})
"""
import logging

_LOGGER_NAME = "benchmarks.reference"
_once_filter = None


class _OnceFilter(logging.Filter):
    """Drop records whose message already passed with log_once set."""

    def __init__(self):
        super().__init__()
        self._seen = set()

    def filter(self, record):
        # only records that THEMSELVES carry log_once participate in the
        # dedupe; a plain record with the same format string still passes.
        # Keyed on (call site, format string) so two files sharing a message
        # don't suppress each other.
        if not getattr(record, "log_once", False):
            return True
        key = (record.pathname, record.lineno, record.msg)
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    def reset(self):
        self._seen.clear()


_FMT = "[%(levelname)s] %(message)s (%(filename)s:%(lineno)d)"


def get_logger(level=None):
    """The process-global framework logger (created on first use)."""
    global _once_filter
    logger = logging.getLogger(_LOGGER_NAME)
    if _once_filter is None:
        _once_filter = _OnceFilter()
        logger.addFilter(_once_filter)
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(logging.INFO)
    if level is not None:
        logger.setLevel(level)
    return logger


def set_log_level(level):
    get_logger().setLevel(level)


def reset_log_once():
    """Forget which messages were already emitted (new experiment)."""
    if _once_filter is not None:
        _once_filter.reset()
