"""Rotating-file + console logger with a per-process id prefix (a copy of
``depthestimation_tpu/utils/logger.py``; the port imports nothing of the
JAX package)."""

from __future__ import annotations

import logging
import logging.handlers
import os


class Logger:
    """``quiet``: warnings only (the data-parallel ranks other than 0)."""

    def __init__(self, name: str, save_root: str | None = None,
                 quiet: bool = False):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.WARNING if quiet else logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            self._logger.addHandler(sh)
            if save_root:
                os.makedirs(save_root, exist_ok=True)
                fh = logging.handlers.RotatingFileHandler(
                    os.path.join(save_root, f"{name}.log"),
                    maxBytes=10 * 1024 * 1024, backupCount=3)
                fh.setFormatter(fmt)
                self._logger.addHandler(fh)

    def info(self, id, msg: str = ""):
        if msg == "":
            id, msg = 0, id
        self._logger.info("[%s] %s", id, msg)

    def warning(self, id, msg: str = ""):
        if msg == "":
            id, msg = 0, id
        self._logger.warning("[%s] %s", id, msg)


def init_logger(name: str = "depthestimation_tpu_torch",
                save_root=None, quiet: bool = False) -> Logger:
    return Logger(name, save_root, quiet)
