"""Engine configuration (the reference hardcodes everything — main.rs:102-104,
mod.rs:63-65; here the knobs are explicit, documented, and overridable).

Consumers read :func:`get` at call time, so :func:`override` (a context
manager) retunes the engine without re-importing — used by tests and the
demo CLI.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["EngineConfig", "DEFAULT", "get", "set_config", "override"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine selection knobs."""

    # engine selection (ops/sort.py)
    default_implementation: str = "comparator"  # what "auto" resolves to


DEFAULT = EngineConfig()
_active = DEFAULT


def get() -> EngineConfig:
    """The active configuration (consumers read this at call time)."""
    return _active


def set_config(cfg: EngineConfig) -> None:
    global _active
    _active = cfg


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily replace configuration fields::

        with config.override(default_implementation="oracle"):
            rst.sort(x)
    """
    global _active
    prev = _active
    set_config(dataclasses.replace(prev, **kwargs))
    try:
        yield _active
    finally:
        set_config(prev)
