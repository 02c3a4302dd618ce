"""The port's own copy of ``icebin_tpu/coupler/units.py``; it imports
nothing of the reference package.

Minimal unit system for contract fields (udunits2 replacement).

Reference: ibmisc wraps the UDUNITS2 C library (``UTSystem``, ``CVConverter``
[U]; SURVEY.md section 2) to parse unit strings from field contracts and
derive conversion factors.  A TPU-native coupler only needs the closed set of
units that appear in ice<->GCM contracts (mass flux, energy flux, temperature,
length, time), so this is a small dimensional-analysis engine over SI base
dimensions -- pure Python at contract-setup time; the resulting affine
(factor, offset) pairs are what get fused into the device apply
(``ops.spmv.apply_matrix`` var_factor/var_offset).
"""
from __future__ import annotations

import dataclasses
import re
from fractions import Fraction

__all__ = ["Unit", "parse_unit", "convert_factor", "UnitError"]

# SI base dimension vector: (kg, m, s, K)
_BASE = {
    "kg": ((1, 0, 0, 0), 1.0, 0.0),
    "g": ((1, 0, 0, 0), 1e-3, 0.0),
    "m": ((0, 1, 0, 0), 1.0, 0.0),
    "km": ((0, 1, 0, 0), 1e3, 0.0),
    "cm": ((0, 1, 0, 0), 1e-2, 0.0),
    "mm": ((0, 1, 0, 0), 1e-3, 0.0),
    "s": ((0, 0, 1, 0), 1.0, 0.0),
    "sec": ((0, 0, 1, 0), 1.0, 0.0),
    "min": ((0, 0, 1, 0), 60.0, 0.0),
    "h": ((0, 0, 1, 0), 3600.0, 0.0),
    "hr": ((0, 0, 1, 0), 3600.0, 0.0),
    "day": ((0, 0, 1, 0), 86400.0, 0.0),
    "d": ((0, 0, 1, 0), 86400.0, 0.0),
    "yr": ((0, 0, 1, 0), 86400.0 * 365.2425, 0.0),
    "year": ((0, 0, 1, 0), 86400.0 * 365.2425, 0.0),
    "K": ((0, 0, 0, 1), 1.0, 0.0),
    "degC": ((0, 0, 0, 1), 1.0, 273.15),
    "Celsius": ((0, 0, 0, 1), 1.0, 273.15),
    # derived
    "J": ((1, 2, -2, 0), 1.0, 0.0),
    "W": ((1, 2, -3, 0), 1.0, 0.0),
    "N": ((1, 1, -2, 0), 1.0, 0.0),
    "Pa": ((1, -1, -2, 0), 1.0, 0.0),
    "1": ((0, 0, 0, 0), 1.0, 0.0),
    "": ((0, 0, 0, 0), 1.0, 0.0),
}


class UnitError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Unit:
    dims: tuple          # exponents over (kg, m, s, K), Fractions
    factor: float        # multiplier to SI
    offset: float = 0.0  # affine offset to SI (temperature only)

    def __mul__(self, o: "Unit") -> "Unit":
        if self.offset or o.offset:
            raise UnitError("cannot multiply affine units")
        return Unit(tuple(a + b for a, b in zip(self.dims, o.dims)),
                    self.factor * o.factor)

    def __pow__(self, p) -> "Unit":
        if self.offset:
            raise UnitError("cannot exponentiate affine units")
        p = Fraction(p)
        return Unit(tuple(d * p for d in self.dims), self.factor ** float(p))


_TOKEN = re.compile(r"([A-Za-z]+|1)(?:\^?(-?\d+(?:/\d+)?))?")


def parse_unit(s: str) -> Unit:
    """Parse udunits-style strings: 'kg m-2 s-1', 'W/m^2', 'degC', 'm s-1'."""
    s = s.strip()
    if s in _BASE:
        d, f, off = _BASE[s]
        return Unit(tuple(Fraction(x) for x in d), f, off)
    # split on '/' -- denominator exponents negate
    parts = s.split("/")
    if len(parts) > 2:
        raise UnitError(f"cannot parse unit {s!r}")
    out = Unit((Fraction(0),) * 4, 1.0)
    for sign, part in zip((1, -1), parts + [""] * (2 - len(parts))):
        for m in _TOKEN.finditer(part):
            name, exp = m.group(1), m.group(2)
            if name not in _BASE:
                raise UnitError(f"unknown unit {name!r} in {s!r}")
            d, f, off = _BASE[name]
            if off != 0.0:
                raise UnitError(f"affine unit {name!r} cannot be combined")
            e = Fraction(exp) if exp else Fraction(1)
            u = Unit(tuple(Fraction(x) for x in d), f) ** (sign * e)
            out = out * u
    return out


def convert_factor(src: str, dst: str):
    """(factor, offset): x_dst = factor * x_src + offset.  Raises UnitError on
    dimension mismatch -- the contract-checking teeth (reference: coupler
    aborts when GCM/ice contracts disagree dimensionally [U])."""
    a, b = parse_unit(src), parse_unit(dst)
    if a.dims != b.dims:
        raise UnitError(f"incompatible units: {src!r} vs {dst!r}")
    factor = a.factor / b.factor
    offset = (a.offset - b.offset) / b.factor
    return factor, offset
