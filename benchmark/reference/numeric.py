"""Numeric primitives shared by the port (counterpart of
``pbrl_tpu/maths/numeric.py``)."""

from __future__ import annotations

import contextlib

import torch

# Squared-norm floor: inputs with ||x|| <= 1e-6 report norm 0.
_EPS_SQ = 1e-12


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm that reports 0 below ``||x|| = 1e-6`` (and has a NaN-free
    gradient there, like the JAX version)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    ok = sq > _EPS_SQ
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


@contextlib.contextmanager
def full_f32():
    """Within the block, float32 matrix products run in full f32 (no TF32),
    whatever the process-wide setting: the engine's inertial products
    need f32's 1e-7, as pbrl_tpu's ``Precision.HIGHEST`` gives them."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full f32 (see :func:`full_f32`)."""
    with full_f32():
        return a @ b


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in full f32 (see :func:`full_f32`)."""
    with full_f32():
        return torch.einsum(eq, *operands)
