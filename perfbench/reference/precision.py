"""The precision a reference computes in: float32, or, in the control, the
next precision below the one its configuration states.

* TF32 (below float32 with TF32 off) keeps float32's exponent and 10 of
  its 23 mantissa bits: each operand rounded to nearest, ties to even.
* float8 (below bfloat16) is e4m3 scaled per tensor (its largest
  magnitude to e4m3's 448), as float8 training scales it.

The control rounds each operand of a convolution or matrix product on the
way in, and each gradient flowing back through that operand on the way
out, and accumulates in float32, as the card's low-precision units do. A
float8 control rounds each product's result too (and the gradient flowing
into it), where the bfloat16 program holds its results in bfloat16.
The rounding is written out rather than asked of the card, so the control
reads the same on the CPU as on the card.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, finite) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_float8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, finite) in float8 e4m3, scaled per tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUND = {"tf32": round_tf32, "float8": round_float8}


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return ROUND[kind](x)

    @staticmethod
    def backward(ctx, g):
        return ROUND[ctx.kind](g), None


def operand(x: torch.Tensor, on: bool, kind: str = "tf32") -> torch.Tensor:
    """``x`` as a convolution or matmul takes it: as it is in float32, or
    rounded to ``kind`` (and its gradient too) in the control."""
    return _Rounded.apply(x, kind) if on else x


def full_float32():
    """Turns TF32 off for cuDNN's convolutions and cuBLAS's matmuls: the
    reference computes in float32 on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
