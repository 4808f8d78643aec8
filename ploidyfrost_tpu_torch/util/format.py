# Copied from ploidyfrost_tpu/util/format.py; imports point at this package.
"""C++-iostream-compatible text formatting.

The reference writes every floating-point value through `ostream <<`
with default precision (6 significant digits, %g semantics) — e.g. the
coverage/frequency tables (src/CDBG.cpp:1303-1317) and the model result
(src/GmmModel.cpp:357-378). Byte-identical outputs require replicating
that formatting exactly.
"""

from __future__ import annotations

import math


def cpp_double(x: float) -> str:
    """Format a double exactly like C++ `ostream << double` (default flags).

    Default C++ formatting is printf %g with precision 6: six significant
    digits, trailing zeros stripped, scientific notation when the decimal
    exponent is < -4 or >= 6, exponent printed with sign and >= 2 digits.
    Python's ``:.6g`` implements the same C99 rules.
    """
    if isinstance(x, float) and math.isnan(x):
        return "nan" if not math.copysign(1.0, x) < 0 else "-nan"
    if isinstance(x, float) and math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return f"{float(x):.6g}"


def cpp_int(x) -> str:
    return str(int(x))
