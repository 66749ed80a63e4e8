"""Precision of the reference's products.

``Exact``: float32 operands, with TF32 off for matrix products and
convolutions (:func:`no_tf32`). ``FP8``: the control, the step below the
port's bfloat16 compute that would tempt a later change: both operands of
every matrix product and convolution rounded to float8 e4m3 with one scale
per tensor (its largest magnitude mapped to 448), the product taken in
float32; gradients pass the rounding unchanged (straight through)."""

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32, with a straight-through gradient."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Exact:
    name = "float32"

    @staticmethod
    def operand(x):
        return x


class FP8:
    name = "fp8_e4m3"

    @staticmethod
    def operand(x):
        return fp8(x)


def linear(prec, x, w, b=None):
    y = torch.matmul(prec.operand(x), prec.operand(w).transpose(-1, -2))
    return y if b is None else y + b


def matmul(prec, a, b):
    return torch.matmul(prec.operand(a), prec.operand(b))
