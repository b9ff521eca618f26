"""Integer helpers reproducing C arithmetic semantics on torch tensors.

The reference does all math on int-promoted values and truncates to
int16 at every array store; C integer division truncates toward zero.
Power-of-two divisions use the branch-free bias+shift form of
ako_tpu/ops/intmath.py (`>>` on int32 is arithmetic). int32 is the
working type throughout: torch's uint32 lacks shifts and compares on
the CPU.
"""

from __future__ import annotations

import torch


def i16(x):
    """Store to int16: wraps like C's (int16_t) cast of an int32."""
    return x.to(torch.int16)


def i32(x):
    return x.to(torch.int32)


def div2(x):
    """Truncating /2 on int32 (C semantics on negatives)."""
    return (x + ((x >> 31) & 1)) >> 1


def div4(x):
    return (x + ((x >> 31) & 3)) >> 2


def div16(x):
    return (x + ((x >> 31) & 15)) >> 4


def div32(x):
    return (x + ((x >> 31) & 31)) >> 5


def divt(x, d):
    """Truncating division with a runtime divisor (C-style)."""
    return torch.div(x, d, rounding_mode="trunc")
