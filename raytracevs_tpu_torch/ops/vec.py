"""3-vector helpers on [..., 3] tensors.

Every sum is written out in component order, ((x0*y0 + x1*y1) + x2*y2),
so the plain PyTorch path rounds exactly as the CUDA kernels do (which
spell the same sums out per thread) on any device.
"""
from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps: float = 1e-12):
    """a / max(|a|, eps) (the JAX package's `_norm`)."""
    return a / torch.clamp(length(a), min=eps)[..., None]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def div_const(x, c: float):
    """x / c as a true float32 division on any device. (PyTorch on CUDA
    turns division by a Python number into multiplication by its
    reciprocal, which rounds differently from the kernels and from the
    CPU; dividing by a 0-d tensor on x's device keeps the division.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def const3(x, y, z, like):
    """A [3] float32 tensor on `like`'s device."""
    return torch.tensor([x, y, z], dtype=torch.float32, device=like.device)


def where3(mask, a, b):
    """torch.where with an [N] mask against [N,3] operands."""
    return torch.where(mask[..., None], a, b)
