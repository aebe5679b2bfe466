"""Number/string formatting — ≙ the reference's `packages/format/`
(format.pony, format_spec.pony, prefix_spec.pony, align.pony,
_format_int.pony, _format_float.pony).

Format.apply(value, fmt=..., prefix=..., width=, precision=, align=,
fill=) with the reference's spec vocabulary expressed as module
constants: FormatHex / FormatHexBare / FormatHexSmall / FormatBinary /
FormatOctal / FormatExp / FormatFix / FormatGeneral, AlignLeft /
AlignRight / AlignCenter, PrefixSign / PrefixSpace / PrefixDefault.
"""

from __future__ import annotations

__all__ = [
    "Format", "FormatDefault", "FormatBinary", "FormatBinaryBare",
    "FormatOctal", "FormatOctalBare", "FormatHex", "FormatHexBare",
    "FormatHexSmall", "FormatHexSmallBare", "FormatExp", "FormatExpLarge",
    "FormatFix", "FormatFixLarge", "FormatGeneral", "FormatGeneralLarge",
    "AlignLeft", "AlignRight", "AlignCenter",
    "PrefixDefault", "PrefixSign", "PrefixSpace",
]

# format specs (≙ format_spec.pony primitives)
FormatDefault = "default"
FormatBinary = "binary"            # 0b1010
FormatBinaryBare = "binary_bare"   # 1010
FormatOctal = "octal"              # 0o777
FormatOctalBare = "octal_bare"
FormatHex = "hex"                  # 0xFF (capitals)
FormatHexBare = "hex_bare"
FormatHexSmall = "hex_small"       # 0xff
FormatHexSmallBare = "hex_small_bare"
FormatExp = "exp"                  # 1.0e+03
FormatExpLarge = "exp_large"       # 1.0E+03
FormatFix = "fix"                  # 1000.00
FormatFixLarge = "fix_large"
FormatGeneral = "general"
FormatGeneralLarge = "general_large"

# alignment (≙ align.pony)
AlignLeft = "left"
AlignRight = "right"
AlignCenter = "center"

# sign prefix (≙ prefix_spec.pony)
PrefixDefault = "prefix_default"   # '-' only
PrefixSign = "prefix_sign"         # always +/-
PrefixSpace = "prefix_space"       # ' ' for positive


_INT_BASES = {
    FormatBinary: (2, "0b", False), FormatBinaryBare: (2, "", False),
    FormatOctal: (8, "0o", False), FormatOctalBare: (8, "", False),
    FormatHex: (16, "0x", True), FormatHexBare: (16, "", True),
    FormatHexSmall: (16, "0x", False), FormatHexSmallBare: (16, "", False),
}

_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def _int_to_base(n: int, base: int) -> str:
    if n == 0:
        return "0"
    out = []
    while n:
        out.append(_DIGITS[n % base])
        n //= base
    return "".join(reversed(out))


class Format:
    """≙ format.pony Format primitive. Call Format(...) or
    Format.apply(...); Format.int / Format.float are the typed
    entry points (≙ _format_int.pony / _format_float.pony)."""

    def __new__(cls, value, **kw):
        return cls.apply(value, **kw)

    @staticmethod
    def apply(value, fmt: str = FormatDefault, prefix: str = PrefixDefault,
              precision: int = -1, width: int = 0, align: str = AlignLeft,
              fill: str = " ") -> str:
        if isinstance(value, bool):
            s = "true" if value else "false"
        elif isinstance(value, int):
            return Format.int(value, fmt, prefix, precision, width, align,
                              fill)
        elif isinstance(value, float):
            return Format.float(value, fmt, prefix, precision, width,
                                align, fill)
        else:
            s = str(value)
            if 0 <= precision < len(s):
                s = s[:precision]
        return Format._pad(s, width, align, fill)

    @staticmethod
    def int(value: int, fmt: str = FormatDefault,
            prefix: str = PrefixDefault, precision: int = -1,
            width: int = 0, align: str = AlignRight,
            fill: str = " ") -> str:
        neg = value < 0
        mag = -value if neg else value
        if fmt in _INT_BASES:
            base, base_prefix, upper = _INT_BASES[fmt]
            digits = _int_to_base(mag, base)
            if upper:
                digits = digits.upper()
        else:
            base_prefix = ""
            digits = str(mag)
        if precision >= 0:
            digits = digits.rjust(precision, "0")
        sign = "-" if neg else (
            "+" if prefix == PrefixSign else
            " " if prefix == PrefixSpace else "")
        return Format._pad(sign + base_prefix + digits, width, align, fill)

    @staticmethod
    def float(value: float, fmt: str = FormatDefault,
              prefix: str = PrefixDefault, precision: int = 6,
              width: int = 0, align: str = AlignRight,
              fill: str = " ") -> str:
        if precision < 0:
            precision = 6
        if fmt in (FormatExp, FormatExpLarge):
            s = f"{value:.{precision}e}"
            if fmt == FormatExpLarge:
                s = s.upper()
        elif fmt in (FormatFix, FormatFixLarge):
            s = f"{value:.{precision}f}"
        elif fmt in (FormatGeneral, FormatGeneralLarge):
            s = f"{value:.{precision}g}"
            if fmt == FormatGeneralLarge:
                s = s.upper()
        else:
            s = repr(float(value))
        if value >= 0:
            if prefix == PrefixSign:
                s = "+" + s
            elif prefix == PrefixSpace:
                s = " " + s
        return Format._pad(s, width, align, fill)

    @staticmethod
    def _pad(s: str, width: int, align: str, fill: str) -> str:
        if len(s) >= width:
            return s
        pad = width - len(s)
        if align == AlignRight:
            return fill * pad + s
        if align == AlignCenter:
            left = pad // 2
            return fill * left + s + fill * (pad - left)
        return s + fill * pad
