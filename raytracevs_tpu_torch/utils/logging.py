"""Leveled file logger (analog of DXEngine/DebugLog.h:9-99).

Errors AND warnings always log; info/debug are gated by `set_log_enabled`
(the reference gates warnings too behind `g_LogEnabled`, but silent
warnings defeat their purpose — e.g. the backend-demotion warning for
oversized meshes must surface without opt-in). Output goes to `debug.log`
in the working directory plus standard `logging` handlers.

Copied from raytracevs_tpu/utils/logging.py (stdlib logging), under the
logger name "raytracevs_tpu_torch".
"""
from __future__ import annotations

import logging

_logger = logging.getLogger("raytracevs_tpu_torch")
_enabled = False
_file_handler = None


def set_log_enabled(enabled: bool, path: str = "debug.log") -> None:
    global _enabled, _file_handler
    _enabled = bool(enabled)
    if _enabled and _file_handler is None:
        _file_handler = logging.FileHandler(path)
        _file_handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s"))
        _logger.addHandler(_file_handler)
        _logger.setLevel(logging.DEBUG)


def log_error(msg: str, *args) -> None:
    _logger.error(msg, *args)


def log_warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def log_info(msg: str, *args) -> None:
    if _enabled:
        _logger.info(msg, *args)


def log_debug(msg: str, *args) -> None:
    if _enabled:
        _logger.debug(msg, *args)
