"""Byte-size string parsing, Spark-conf style ("4k", "8m", "25g").

A verbatim copy of the JAX package's ``utils/units.py``.

Reference semantics: SparkConf.getSizeAsBytes as used by
RdmaShuffleConf.scala:47-58 (values are suffixed byte strings; bare
integers are bytes).
"""

from __future__ import annotations

_SUFFIXES = {
    "": 1,
    "b": 1,
    "k": 1 << 10,
    "kb": 1 << 10,
    "m": 1 << 20,
    "mb": 1 << 20,
    "g": 1 << 30,
    "gb": 1 << 30,
    "t": 1 << 40,
    "tb": 1 << 40,
}


def parse_bytes(value) -> int:
    """Parse a byte-size value: int passes through, strings accept k/m/g/t suffixes."""
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip().lower()
    i = len(s)
    while i > 0 and not s[i - 1].isdigit():
        i -= 1
    num, suffix = s[:i], s[i:].strip()
    if not num or suffix not in _SUFFIXES:
        raise ValueError(f"cannot parse byte size: {value!r}")
    return int(num) * _SUFFIXES[suffix]


def format_bytes(n: int) -> str:
    for unit, div in (("g", 1 << 30), ("m", 1 << 20), ("k", 1 << 10)):
        if n >= div and n % div == 0:
            return f"{n // div}{unit}"
    return str(n)
