"""resource.Quantity — canonicalized SI resource amounts.

Port of ``kubernetes_tpu/api/quantity.py`` (ref: pkg/api/resource/
quantity.go + suffix.go): a fixed-point decimal/binary quantity with suffix
canonicalization, the basis of all capacity math (node capacity, pod
requests/limits, quota).

Internally the amount is an exact rational (numerator/denominator over powers
of 2 and 10), so milli-CPU arithmetic and binary-SI byte arithmetic are both
exact. Formatting follows the reference's canonicalization rules: the suffix
family of the original string is preserved (BinarySI / DecimalSI /
DecimalExponent), and values are printed with the largest suffix that keeps
the mantissa integral.
"""

from __future__ import annotations

import re
from fractions import Fraction
from functools import total_ordering

__all__ = ["Quantity", "parse_quantity", "QuantityError"]


class QuantityError(ValueError):
    pass


# Suffix tables (ref: pkg/api/resource/suffix.go).
_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
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


@total_ordering
class Quantity:
    """An exact resource amount with a preferred display format.

    Construction: ``Quantity("100m")``, ``Quantity("1.5Gi")``, ``Quantity(2)``,
    ``Quantity("3e6")``. Arithmetic (+, -, comparison) is exact.
    """

    # _milli_cache/_int_cache/_str_cache memoize the accessor results
    # (arithmetic always returns new Quantity objects, so .value never
    # mutates in place); the str form is the wire encoding and dominates
    # per-object serialization cost via Fraction arithmetic otherwise
    __slots__ = ("value", "format", "_milli_cache", "_int_cache",
                 "_str_cache")

    def __init__(self, value="0", fmt=None):
        if isinstance(value, Quantity):
            self.value = value.value
            self.format = fmt or value.format
            return
        if isinstance(value, (int,)):
            self.value = Fraction(value)
            self.format = fmt or DECIMAL_SI
            return
        if isinstance(value, float):
            # Floats are accepted for convenience but converted via str to
            # avoid binary-float dust (0.1 -> 1/10, not 0.1000000000000000055).
            value = repr(value)
        if isinstance(value, Fraction):
            self.value = value
            self.format = fmt or DECIMAL_SI
            return
        if not isinstance(value, str):
            raise QuantityError(f"cannot parse quantity from {type(value)!r}")
        v, f = _parse(value)
        self.value = v
        self.format = fmt or f

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        other = Quantity(other)
        # a zero accumulator adopts the operand's format so that
        # Quantity("0") + Quantity("64Mi") prints "64Mi", not raw bytes
        # (quota usage strings stay human-canonical)
        fmt = self.format if self.value else other.format
        return Quantity(self.value + other.value, fmt)

    def __sub__(self, other):
        other = Quantity(other)
        fmt = self.format if self.value else other.format
        return Quantity(self.value - other.value, fmt)

    def __neg__(self):
        return Quantity(-self.value, self.format)

    def __eq__(self, other):
        if other is None:
            return False
        try:
            return self.value == Quantity(other).value
        except (QuantityError, TypeError):
            return NotImplemented

    def __lt__(self, other):
        try:
            return self.value < Quantity(other).value
        except (QuantityError, TypeError):
            return NotImplemented

    def __hash__(self):
        return hash(self.value)

    def __bool__(self):
        return self.value != 0

    # Value-immutable: arithmetic returns new instances and the caches are
    # pure memos, so isolation copies (the in-process transport and the
    # store make one per request) can share the instance. This prunes the
    # deepest, most object-heavy leaves out of every Pod deepcopy — the
    # dominant cost of the create path at churn rates.
    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    # -- accessors ----------------------------------------------------------
    # memoized: the snapshot encoder calls these once per pod-resource per
    # wave and Fraction arithmetic dominates the host encode profile
    def milli_value(self) -> int:
        """Value scaled by 1000, rounded up (ref: quantity.go MilliValue)."""
        cached = getattr(self, "_milli_cache", None)
        if cached is None:
            v = self.value * 1000
            cached = -(-v.numerator // v.denominator)  # ceil
            object.__setattr__(self, "_milli_cache", cached)
        return cached

    def int_value(self) -> int:
        """Value rounded up to the nearest integer (ref: quantity.go Value)."""
        cached = getattr(self, "_int_cache", None)
        if cached is None:
            v = self.value
            cached = -(-v.numerator // v.denominator)
            object.__setattr__(self, "_int_cache", cached)
        return cached

    def to_float(self) -> float:
        return float(self.value)

    def is_zero(self) -> bool:
        return self.value == 0

    def copy(self) -> "Quantity":
        return Quantity(self.value, self.format)

    # -- formatting ---------------------------------------------------------
    def __str__(self) -> str:
        cached = getattr(self, "_str_cache", None)
        if cached is None:
            # global memo too: decode creates a fresh instance per object
            # (so the per-instance cache starts cold every time), yet the
            # wire value vocabulary under churn is a handful of strings
            fk = (self.value, self.format)
            cached = _FORMAT_CACHE.get(fk)
            if cached is None:
                cached = _format(self.value, self.format)
                if len(_FORMAT_CACHE) >= _PARSE_CACHE_MAX:
                    _FORMAT_CACHE.clear()
                _FORMAT_CACHE[fk] = cached
            object.__setattr__(self, "_str_cache", cached)
        return cached

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"


# string -> (Fraction, fmt) memo: decode paths parse the same handful of
# wire strings ("100m", "128Mi", ...) millions of times under churn, and
# Fraction construction dominates. Both members of the tuple are
# immutable, so sharing across instances is safe. Bounded by wholesale
# clear (the working set is tiny; eviction order is irrelevant).
_PARSE_CACHE: dict = {}
_PARSE_CACHE_MAX = 4096
# (Fraction value, fmt) -> wire string; same bounding discipline
_FORMAT_CACHE: dict = {}


def _parse(s: str):
    hit = _PARSE_CACHE.get(s)
    if hit is not None:
        return hit
    out = _parse_uncached(s)
    if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
        _PARSE_CACHE.clear()
    _PARSE_CACHE[s] = out
    return out


def _parse_uncached(s: str):
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise QuantityError(f"unable to parse quantity {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    num = Fraction(m.group("num"))
    suffix = m.group("suffix")
    exp = m.group("exp")
    if exp is not None:
        val = num * Fraction(10) ** int(exp)
        fmt = DECIMAL_EXPONENT
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
        # Largest binary suffix with an integral mantissa; fall back to
        # decimal-SI for sub-integer amounts (ref: suffix.go interpretation).
        for suf in _BINARY_ORDER:
            scale = _BINARY_SUFFIXES.get(suf, 1)
            scaled = v / scale
            if scaled.denominator == 1 and (suf == "" or scaled.numerator >= 1):
                return f"{sign}{scaled.numerator}{suf}"
        fmt = DECIMAL_SI
    if fmt == DECIMAL_EXPONENT:
        # mantissa * 10^exp with integral mantissa; exponent a multiple of 3
        # (ref: suffix.go decimalExponent formats via e3/e6/...). Rationals
        # whose denominator is not 2^a*5^b (e.g. 1/3) have no finite decimal
        # form — round those up at nano precision like the DecimalSI fallback.
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
        if exp == 0:
            return f"{sign}{mant}"
        return f"{sign}{mant}e{exp}"
    # DecimalSI: largest decimal suffix keeping the mantissa integral.
    for suf in _DECIMAL_ORDER:
        scale = _DECIMAL_SUFFIXES[suf]
        scaled = v / scale
        if scaled.denominator == 1:
            return f"{sign}{scaled.numerator}{suf}"
    # Smaller than 1n: print as nano rounded up (reference rounds up on
    # lossy canonicalization, quantity.go:239).
    scaled = v / _DECIMAL_SUFFIXES["n"]
    return f"{sign}{-(-scaled.numerator // scaled.denominator)}n"


def parse_quantity(s) -> Quantity:
    return Quantity(s)
