"""resource.Quantity — exact SI resource amounts (parsing, integer views,
canonical wire strings).

Port of ``kubernetes_tpu/api/quantity.py`` trimmed to what the scheduler
reads and writes: parsing a quantity string, its ``milli_value`` /
``int_value`` (ref: pkg/api/resource/quantity.go), value equality, and the
canonical string the wire codec encodes (ref: suffix.go). The amount is an
exact rational, so milli-CPU and binary-SI byte arithmetic are both exact.
Arithmetic between quantities is not ported.
"""

from __future__ import annotations

import re
from fractions import Fraction

__all__ = ["Quantity", "QuantityError"]


class QuantityError(ValueError):
    pass


# Suffix tables (ref: pkg/api/resource/suffix.go).
_BINARY_SUFFIXES = {
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30,
    "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9), "u": Fraction(1, 10**6), "m": Fraction(1, 10**3),
    "": Fraction(1), "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
    "P": 10**15, "E": 10**18,
}
# Ordered largest-first for canonical formatting.
_BINARY_ORDER = ["Ei", "Pi", "Ti", "Gi", "Mi", "Ki", ""]
_DECIMAL_ORDER = ["E", "P", "T", "G", "M", "k", "", "m", "u", "n"]

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>[numkMGTPE]|[KMGTPE]i)|[eE](?P<exp>[+-]?\d+))?$"
)

BINARY_SI = "BinarySI"
DECIMAL_SI = "DecimalSI"
DECIMAL_EXPONENT = "DecimalExponent"


class Quantity:
    """An exact resource amount with its preferred display format:
    ``Quantity("100m")``, ``Quantity("1.5Gi")``, ``Quantity(2)``,
    ``Quantity("3e6")``. Value-immutable; the integer views and the wire
    string are memoized (decoding a cluster parses the same handful of
    strings once per object)."""

    __slots__ = ("value", "format", "_milli_cache", "_int_cache",
                 "_str_cache")

    def __init__(self, value="0", fmt=None):
        if isinstance(value, Quantity):
            self.value = value.value
            self.format = fmt or value.format
        elif isinstance(value, (int, Fraction)):
            self.value = Fraction(value)
            self.format = fmt or DECIMAL_SI
        elif isinstance(value, (float, str)):
            # a float goes via its repr, so 0.1 is 1/10 and not binary dust
            v, f = _parse(repr(value) if isinstance(value, float) else value)
            self.value = v
            self.format = fmt or f
        else:
            raise QuantityError(f"cannot parse quantity from {type(value)!r}")

    def __eq__(self, other):
        if other is None:
            return False
        try:
            return self.value == Quantity(other).value
        except (QuantityError, TypeError):
            return NotImplemented

    def __hash__(self):
        return hash(self.value)

    def __bool__(self):
        return self.value != 0

    def milli_value(self) -> int:
        """Value scaled by 1000, rounded up (ref: quantity.go MilliValue)."""
        cached = getattr(self, "_milli_cache", None)
        if cached is None:
            v = self.value * 1000
            cached = -(-v.numerator // v.denominator)
            self._milli_cache = cached
        return cached

    def int_value(self) -> int:
        """Value rounded up to the nearest integer (ref: quantity.go Value)."""
        cached = getattr(self, "_int_cache", None)
        if cached is None:
            v = self.value
            cached = -(-v.numerator // v.denominator)
            self._int_cache = cached
        return cached

    def __str__(self) -> str:
        """The canonical wire string (ref: suffix.go)."""
        cached = getattr(self, "_str_cache", None)
        if cached is None:
            key = (self.value, self.format)
            cached = _FORMAT_CACHE.get(key)
            if cached is None:
                cached = _format(self.value, self.format)
                if len(_FORMAT_CACHE) >= _CACHE_MAX:
                    _FORMAT_CACHE.clear()
                _FORMAT_CACHE[key] = cached
            self._str_cache = cached
        return cached

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"


# string -> (Fraction, format) and (Fraction, format) -> string memos; both
# sides are immutable, so instances share them. Bounded by clearing.
_PARSE_CACHE: dict = {}
_FORMAT_CACHE: dict = {}
_CACHE_MAX = 4096


def _parse(s: str):
    hit = _PARSE_CACHE.get(s)
    if hit is None:
        hit = _parse_uncached(s)
        if len(_PARSE_CACHE) >= _CACHE_MAX:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[s] = hit
    return hit


def _parse_uncached(s: str):
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        raise QuantityError(f"unable to parse quantity {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    num = Fraction(m.group("num"))
    suffix, exp = m.group("suffix"), m.group("exp")
    if exp is not None:
        val, fmt = num * Fraction(10) ** int(exp), DECIMAL_EXPONENT
    elif suffix is None:
        val, fmt = num, DECIMAL_SI
    elif suffix in _BINARY_SUFFIXES:
        val, fmt = num * _BINARY_SUFFIXES[suffix], BINARY_SI
    else:
        val, fmt = num * _DECIMAL_SUFFIXES[suffix], DECIMAL_SI
    return sign * val, fmt


def _format(v: Fraction, fmt: str) -> str:
    if v == 0:
        return "0"
    sign = "-" if v < 0 else ""
    v = abs(v)
    if fmt == BINARY_SI:
        # largest binary suffix with an integral mantissa; sub-integer
        # amounts fall back to decimal SI
        for suf in _BINARY_ORDER:
            scaled = v / _BINARY_SUFFIXES.get(suf, 1)
            if scaled.denominator == 1 and (suf == "" or scaled.numerator >= 1):
                return f"{sign}{scaled.numerator}{suf}"
        fmt = DECIMAL_SI
    if fmt == DECIMAL_EXPONENT:
        # integral mantissa * 10^exp, exp a multiple of 3; a rational with
        # no finite decimal form rounds up at nano precision
        exp = 0
        val = v
        for _ in range(30):
            if val.denominator == 1:
                break
            val *= 10
            exp -= 1
        if val.denominator != 1:
            val = Fraction(-(-val.numerator // val.denominator))
        mant = val.numerator
        while mant % 10 == 0 and mant != 0:
            mant //= 10
            exp += 1
        while exp % 3 != 0:
            mant *= 10
            exp -= 1
        return f"{sign}{mant}" if exp == 0 else f"{sign}{mant}e{exp}"
    # decimal SI: largest suffix keeping the mantissa integral
    for suf in _DECIMAL_ORDER:
        scaled = v / _DECIMAL_SUFFIXES[suf]
        if scaled.denominator == 1:
            return f"{sign}{scaled.numerator}{suf}"
    # below 1n: nano, rounded up (ref: quantity.go:239)
    scaled = v / _DECIMAL_SUFFIXES["n"]
    return f"{sign}{-(-scaled.numerator // scaled.denominator)}n"
