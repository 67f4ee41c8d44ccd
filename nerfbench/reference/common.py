"""What every family's plain reference shares: the product functions
through which a reference computes its matrix products, TF32 switched off,
and the rays of a pinhole camera.

A reference computes in float32 with TF32 off (``fp32`` inside
``no_tf32``). The control computes the same code with ``fp8``: the
operands of every product rounded to float8 e4m3 with one scale a tensor,
in the forward and in the backward, as the program rounds its operands and
its deltas to bfloat16. A family's reference takes the product function as
an argument, so that one control serves every family.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32."""
    return x @ w


def round8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at the format's largest value), back in float32."""
    scale = FP8_MAX / torch.clamp(x.abs().amax(), min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Product(torch.autograd.Function):
    """``x @ w`` with both operands rounded by ``round8``; its backward
    rounds the incoming gradient too and multiplies it with the rounded
    operands, so every product of a step is a float8 product."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = round8(x), round8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = round8(g)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as float8 e4m3 products, forward and backward."""
    return _Fp8Product.apply(x, w)


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 (TF32 off) inside the block."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def pixel_rays(px, py, width, height, focal, c2w):
    """World ray origins and (unnormalized) directions of pixels ``(px,
    py)`` of a pinhole camera looking down its -z axis."""
    d = torch.stack([(px.float() - width * 0.5) / focal,
                     -(py.float() - height * 0.5) / focal,
                     -torch.ones_like(px, dtype=torch.float32)], -1)
    rays_d = d @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d
