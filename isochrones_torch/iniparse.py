"""Minimal ``star.ini`` parser (ConfigObj-lite), the JAX package's
``isochrones_tpu/iniparse.py`` verbatim (host code, no array library).

The reference uses the external ``configobj`` package
(``isochrones/starmodel.py:248-436``, ``observation.py:10``); this
self-contained parser supports the subset the ``star.ini`` format uses:
top-level ``key = value`` pairs, one level of ``[sections]``, comma-separated
value lists, and ``#`` comments.
"""

from __future__ import annotations

from typing import Dict, List, Union

__all__ = ["parse_ini", "parse_value", "IniSection"]


class IniSection(dict):
    """A named section: plain dict of raw string (or list-of-string) values."""


def _split_value(raw: str) -> Union[str, List[str]]:
    raw = raw.strip()
    if "," in raw:
        return [p.strip() for p in raw.split(",")]
    return raw


def parse_ini(filename) -> Dict[str, Union[str, List[str], IniSection]]:
    """Parse an ini file into {key: value-or-IniSection}. Values stay raw
    strings (or lists of strings) — use :func:`parse_value` to coerce."""
    result: Dict = {}
    current = result
    with open(filename) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                name = line[1:-1].strip()
                sec = IniSection()
                result[name] = sec
                current = sec
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                current[k.strip()] = _split_value(v)
    return result


def parse_value(v):
    """Coerce a raw ini value: float, list-of-floats, or raw string
    (reference ``_parse_config_value``, starmodel.py:51-59)."""
    if isinstance(v, (list, tuple)):
        try:
            return [float(x) for x in v]
        except (TypeError, ValueError):
            return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
