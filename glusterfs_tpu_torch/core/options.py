"""Typed per-layer option framework.

The reference gives every xlator a ``volume_option_t`` table with typed
validation (int/bool/percent/size/time/string-enum, min/max, defaults) and
runtime ``reconfigure`` (reference libglusterfs/src/options.c:20-326,
glusterfs/options.h ``GF_OPTION_INIT``/``GF_OPTION_RECONF``).  Same model
here: each Layer class declares ``OPTIONS``; values are validated at graph
build and on reconfigure.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([KMGTP]?)I?B?$", re.IGNORECASE)
_TIME_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*(s|sec|min|h|hr|d|w|ms)?$")

_SIZE_MULT = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30,
              "T": 1 << 40, "P": 1 << 50}
_TIME_MULT = {None: 1.0, "s": 1.0, "sec": 1.0, "min": 60.0, "h": 3600.0,
              "hr": 3600.0, "d": 86400.0, "w": 604800.0, "ms": 0.001}

_BOOL_TRUE = {"1", "on", "yes", "true", "enable", "enabled"}
_BOOL_FALSE = {"0", "off", "no", "false", "disable", "disabled"}


class OptionError(ValueError):
    pass


def parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in _BOOL_TRUE:
        return True
    if s in _BOOL_FALSE:
        return False
    raise OptionError(f"not a boolean: {v!r}")


def parse_size(v: Any) -> int:
    """'64KB', '1M', '512' -> bytes (reference gf_string2bytesize)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    m = _SIZE_RE.match(str(v).strip())
    if not m:
        raise OptionError(f"not a size: {v!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).upper()])


def parse_time(v: Any) -> float:
    """'10', '500ms', '2min' -> seconds (reference gf_string2time)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    m = _TIME_RE.match(str(v).strip().lower())
    if not m:
        raise OptionError(f"not a time: {v!r}")
    return float(m.group(1)) * _TIME_MULT[m.group(2)]


@dataclasses.dataclass(frozen=True)
class Option:
    """One typed option (volume_option_t analog)."""

    name: str
    otype: str = "str"  # str | int | bool | size | time | percent | enum | path
    default: Any = None
    min: float | None = None
    max: float | None = None
    values: tuple[str, ...] | None = None  # for enum
    description: str = ""
    validate_fn: Callable[[Any], Any] | None = None

    def parse(self, value: Any) -> Any:
        try:
            if self.otype == "int":
                out: Any = int(value)
            elif self.otype == "bool":
                out = parse_bool(value)
            elif self.otype == "size":
                out = parse_size(value)
            elif self.otype == "time":
                out = parse_time(value)
            elif self.otype == "percent":
                s = str(value).rstrip("%")
                out = float(s)
            elif self.otype == "enum":
                out = str(value)
                if self.values and out not in self.values:
                    raise OptionError(
                        f"{self.name}: {out!r} not in {self.values}")
            else:
                out = str(value) if not isinstance(value, str) else value
        except (TypeError, ValueError) as e:
            raise OptionError(f"option {self.name}: {e}") from e
        if self.min is not None and out < self.min:
            raise OptionError(f"option {self.name}={out} below min {self.min}")
        if self.max is not None and out > self.max:
            raise OptionError(f"option {self.name}={out} above max {self.max}")
        if self.validate_fn is not None:
            out = self.validate_fn(out)
        return out


def validate_options(table: tuple[Option, ...], raw: dict[str, Any],
                     *, strict: bool = False) -> dict[str, Any]:
    """Parse raw option strings against a table; unknown keys pass through
    untyped unless strict (the reference warns on unknown options)."""
    byname = {o.name: o for o in table}
    out: dict[str, Any] = {o.name: o.parse(o.default)
                           for o in table if o.default is not None}
    for key, val in raw.items():
        opt = byname.get(key)
        if opt is None:
            if strict:
                raise OptionError(f"unknown option {key!r}")
            out[key] = val
        else:
            out[key] = opt.parse(val)
    return out
