"""Env-var parsing for the port's VTPU_* and TPU_* readers.

A copy of ``vtpu/utils/envs.py`` (the port imports nothing of vtpu), with
the same semantics: empty string = default, bad value = default, never
raise -- except :func:`env_require`.
"""

from __future__ import annotations

import os

# truthy spellings accepted by env_bool; "true" matches the chart's
# values.yaml booleans, "1" the shell convention
_TRUE = ("1", "true", "yes", "on")


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    """Raw string value; empty/unset = default."""
    return os.environ.get(name, "") or default


def env_bool(name: str, default: bool = False) -> bool:
    """"1"/"true"/"yes"/"on" (any case) = True; unset/empty = default;
    anything else = False."""
    raw = os.environ.get(name, "")
    if raw == "":
        return default
    return raw.strip().lower() in _TRUE


def env_require(name: str) -> str:
    """A value the caller cannot run without — raises KeyError with the
    env name when unset (the launcher contract, e.g. VTPU_SHIM_SO)."""
    return os.environ[name]
