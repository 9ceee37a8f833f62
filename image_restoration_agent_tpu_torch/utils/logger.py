"""Logger factory: colored console + file handlers (the port's copy of
``image_restoration_agent_tpu/utils/logger.py``, a rebuild of
AgenticIR/utils/logger.py:33-72)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

_COLORS = {
    logging.DEBUG: "\033[36m", logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m", logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color else msg


def get_logger(
    logger_name: str,
    log_file: Optional[Path] = None,
    console_log_level: int = logging.INFO,
    file_log_level: int = logging.DEBUG,
    console_format_str: str = "%(asctime)s - %(levelname)s\n%(message)s",
    file_format_str: str = "%(asctime)s - %(levelname)s\n%(message)s\n",
    silent: bool = False,
) -> logging.Logger:
    logger = logging.getLogger(f"{logger_name}:{log_file}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.handlers.clear()

    if not silent:
        ch = logging.StreamHandler()
        ch.setLevel(console_log_level)
        ch.setFormatter(_ColorFormatter(console_format_str))
        logger.addHandler(ch)

    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(file_log_level)
        fh.setFormatter(logging.Formatter(file_format_str))
        logger.addHandler(fh)

    return logger
