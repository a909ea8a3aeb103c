"""The precision the reference computes in: float32, or the control's.

The configurations state float32 with TF32 off.  The reference computes
every product in float32 (``allow_tf32`` off) and, as the control, one step
lower: its products on TF32 operands (the low 13 mantissa bits of each
operand rounded away, to nearest even, the rounding the tensor cores apply
to float32 inputs; sums stay float32) and its elementwise frontend in
bfloat16.  The TF32 rounding is done here, explicitly, so the control reads
the same on the card and on the CPU.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) >> 13) << 13
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class Precision:
    """``mm`` for every product, ``ew`` around the elementwise frontend."""

    def __init__(self, control: bool = False):
        self.control = bool(control)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    @property
    def ew_dtype(self):
        return torch.bfloat16 if self.control else torch.float32


F32 = Precision(False)
CONTROL = Precision(True)
