"""resource.Quantity — exact SI resource amounts (parsing + integer views).

Port of ``kubernetes_tpu/api/quantity.py`` trimmed to what the scheduling
wave reads: parsing a quantity string and its ``milli_value`` /
``int_value`` (ref: pkg/api/resource/quantity.go). The amount is an exact
rational, so milli-CPU and binary-SI byte arithmetic are both exact.
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

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>[numkMGTPE]|[KMGTPE]i)|[eE](?P<exp>[+-]?\d+))?$"
)


class Quantity:
    """An exact resource amount: ``Quantity("100m")``, ``Quantity("1.5Gi")``,
    ``Quantity(2)``, ``Quantity("3e6")``."""

    __slots__ = ("value",)

    def __init__(self, value="0"):
        if isinstance(value, Quantity):
            self.value = value.value
        elif isinstance(value, (int, Fraction)):
            self.value = Fraction(value)
        elif isinstance(value, float):
            # via str, so 0.1 is 1/10 and not binary-float dust
            self.value = _parse(repr(value))
        elif isinstance(value, str):
            self.value = _parse(value)
        else:
            raise QuantityError(f"cannot parse quantity from {type(value)!r}")

    def milli_value(self) -> int:
        """Value scaled by 1000, rounded up (ref: quantity.go MilliValue)."""
        v = self.value * 1000
        return -(-v.numerator // v.denominator)

    def int_value(self) -> int:
        """Value rounded up to the nearest integer (ref: quantity.go Value)."""
        v = self.value
        return -(-v.numerator // v.denominator)


def _parse(s: str) -> Fraction:
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        raise QuantityError(f"unable to parse quantity {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    num = Fraction(m.group("num"))
    suffix, exp = m.group("suffix"), m.group("exp")
    if exp is not None:
        val = num * Fraction(10) ** int(exp)
    elif suffix is None:
        val = num
    elif suffix in _BINARY_SUFFIXES:
        val = num * _BINARY_SUFFIXES[suffix]
    else:
        val = num * _DECIMAL_SUFFIXES[suffix]
    return sign * val
