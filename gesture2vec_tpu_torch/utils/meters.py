"""Logging utilities of the trainers (the port's copy of the JAX
package's `utils/meters.py`): a running-average meter and the stream +
rotating-file logger."""
from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional


class AverageMeter:
    def __init__(self, name: str = "meter", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        spec = self.fmt.lstrip(":")
        return (f"{self.name} {format(self.val, spec)} "
                f"({format(self.avg, spec)})")


def set_logger(log_dir: Optional[str] = None,
               log_filename: str = "log.txt",
               level: int = logging.DEBUG) -> None:
    handlers = [logging.StreamHandler()]
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, log_filename),
            maxBytes=10 * 1024 * 1024, backupCount=5))
    logging.basicConfig(
        level=level, handlers=handlers, force=True,
        format="%(asctime)s %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
