"""Runtime-tunable logging registry (reference common/flogging).

A copy of the JAX package's `common/flogging`, its loggers rooted at
`fabric_tpu_torch` instead of `fabric_tpu`.

The reference wraps zap with a global registry whose per-logger levels can
be mutated at runtime through a "level spec" string, served over the
operations HTTP endpoint /logspec (common/flogging/loggerlevels.go,
core/operations/system.go:149). This module provides the same contract on
top of the stdlib ``logging`` package:

* ``must_get_logger(name)`` — hierarchical loggers ("gossip.state").
* ``activate_spec(spec)`` — spec grammar matching the reference's
  ``logger1,logger2=level:logger3=level:defaultlevel``; the last bare
  level (no ``=``) sets the default; prefixes apply to whole subtrees.
* ``spec()`` — the currently-active spec string (round-trips).

Levels accepted (case-insensitive): debug, info, warn/warning, error,
panic/dpanic/fatal (mapped to CRITICAL).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "panic": logging.CRITICAL,
    "dpanic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
}
_LEVEL_NAMES = {
    logging.DEBUG: "debug",
    logging.INFO: "info",
    logging.WARNING: "warn",
    logging.ERROR: "error",
    logging.CRITICAL: "fatal",
}

ROOT = "fabric_tpu_torch"
_lock = threading.Lock()
_default_level = logging.INFO
_overrides: Dict[str, int] = {}  # logger-name prefix -> level
_configured = False


class InvalidSpecError(ValueError):
    pass


def _ensure_handler() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname).4s [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        root.addHandler(handler)
    root.propagate = False
    _configured = True


def _apply_locked() -> None:
    """Re-derive effective levels for every known logger under ROOT."""
    _ensure_handler()
    logging.getLogger(ROOT).setLevel(_default_level)
    # Reset previously-touched loggers to inherit, then set overrides.
    manager = logging.Logger.manager
    for name, logger in list(manager.loggerDict.items()):
        if not isinstance(logger, logging.Logger):
            continue
        if name == ROOT or not name.startswith(ROOT + "."):
            continue
        logger.setLevel(_level_for(name[len(ROOT) + 1 :]))


def _level_for(short_name: str) -> int:
    """Longest-prefix override match, else the default level."""
    best, best_len = _default_level, -1
    for prefix, level in _overrides.items():
        if short_name == prefix or short_name.startswith(prefix + "."):
            if len(prefix) > best_len:
                best, best_len = level, len(prefix)
    return best


def must_get_logger(name: str) -> logging.Logger:
    """A named logger under the fabric_tpu_torch hierarchy, levels governed by
    the active spec."""
    with _lock:
        _ensure_handler()
        logger = logging.getLogger(f"{ROOT}.{name}")
        logger.setLevel(_level_for(name))
        return logger


def activate_spec(spec_str: str) -> None:
    """Parse and apply a level spec (common/flogging/loggerlevels.go:28).

    Grammar: colon-separated fields; ``a,b=level`` overrides loggers a,b
    (and their subtrees); a bare ``level`` field sets the default.
    """
    global _default_level
    new_default = logging.INFO
    new_overrides: Dict[str, int] = {}
    for field in spec_str.split(":"):
        field = field.strip()
        if not field:
            continue
        if "=" in field:
            names, _, level_name = field.rpartition("=")
            level = _LEVELS.get(level_name.strip().lower())
            if level is None or not names:
                raise InvalidSpecError(f"invalid logging specification: {field!r}")
            for name in names.split(","):
                name = name.strip().rstrip(".")
                if not name:
                    raise InvalidSpecError(
                        f"invalid logging specification: {field!r}"
                    )
                new_overrides[name] = level
        else:
            level = _LEVELS.get(field.lower())
            if level is None:
                raise InvalidSpecError(f"invalid logging specification: {field!r}")
            new_default = level
    with _lock:
        _default_level = new_default
        _overrides.clear()
        _overrides.update(new_overrides)
        _apply_locked()


def spec() -> str:
    """The active spec string (mirrors LoggerLevels.Spec)."""
    with _lock:
        fields = [
            f"{name}={_LEVEL_NAMES[level]}"
            for name, level in sorted(_overrides.items())
        ]
        fields.append(_LEVEL_NAMES[_default_level])
        return ":".join(fields)


def reset() -> None:
    """Test helper: back to info-everything."""
    activate_spec("info")
