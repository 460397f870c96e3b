"""Logging setup (intact_tpu/utils/monitor.py::setup_logger, copied)."""

from __future__ import annotations

import logging
import sys


def setup_logger(
    main_rank: bool,
    filename: str | None = None,
    name: str = "intact_tpu_torch",
    level: int = logging.INFO,
    force: bool = False,
) -> logging.Logger:
    """Per-name logger; non-main ranks get a silent logger.

    force=True replaces existing handlers (a process that must switch a
    logger to another file)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not main_rank:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger
    if logger.handlers:
        if not force:
            return logger
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    handler = logging.FileHandler(filename) if filename else logging.StreamHandler(sys.stdout)
    handler.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    )
    logger.addHandler(handler)
    logger.propagate = False
    return logger
