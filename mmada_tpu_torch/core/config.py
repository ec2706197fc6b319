"""Strict parsing of the serving flags.

The port's copy of `parse_kv_cache` (`mmada_tpu/core/config.py:244-259`):
`bool("int8")` and `bool("false")` are both True, so a `kv_cache` flag that
arrives as a string goes through an explicit table instead.
"""

from __future__ import annotations


def parse_kv_cache(value):
    """A `kv_cache` value (bool, or a CLI / HTTP string) -> False | True |
    "int8"; any other string raises."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v == "int8":
            return "int8"
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"kv_cache must be true/false/int8, got {value!r}")
    return "int8" if value == "int8" else bool(value)
