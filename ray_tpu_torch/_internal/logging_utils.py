"""Structured per-process logging (ref analog: src/ray/util/logging.h +
python/ray/_private/log_monitor.py, simplified: every process logs to
stderr and, when RAYT_LOG_DIR is set, to <log_dir>/<component>-<pid>.log)."""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(component: str, level: str | None = None) -> logging.Logger:
    from ray_tpu_torch._internal.config import get_config

    cfg = get_config()
    logger = logging.getLogger(f"ray_tpu_torch.{component}")
    if getattr(logger, "_rayt_configured", False):
        return logger
    logger._rayt_configured = True  # type: ignore[attr-defined]
    logger.setLevel(level or cfg.log_level)
    fmt = logging.Formatter(
        f"%(asctime)s {component}(pid={os.getpid()}) %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    log_dir = cfg.log_dir or os.environ.get("RAYT_LOG_DIR", "")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(log_dir, f"{component}-{os.getpid()}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
