"""Unrolled small-matrix SPD solvers (counterpart of ``pbrl_tpu/ops/linalg.py``).

The same column algorithm as pbrl_tpu's: the factor is unrolled over the
(static, small) matrix size with the diagonal floored at 1e-12, so a
marginally indefinite f32 matrix gives a finite factor where
``torch.linalg.cholesky`` raises. Each column is a few whole-batch tensor
operations on a working block that shrinks by one row and column per step;
the entries it drops are the ones pbrl_tpu's masks leave unchanged, so the
arithmetic per entry is the same. Everything is out of place, so autograd
runs through it. Used by the engine's integrator and contact masses and by
Stable PD.
"""

from __future__ import annotations

import torch

_FLOOR = 1e-12
_TRIL = {}


def _tril_index(n: int, device) -> torch.Tensor:
    """Gather index that lays the packed columns of a factor out as (n, n):
    entry (i, j), i >= j, is the (i - j)-th element of column j; the upper
    triangle reads the zero appended at the end."""
    key = (n, str(device))
    if key not in _TRIL:
        start, idx = 0, torch.full((n, n), n * (n + 1) // 2, dtype=torch.long)
        for j in range(n):
            idx[j:, j] = torch.arange(start, start + n - j)
            start += n - j
        _TRIL[key] = idx.reshape(-1).to(device)
    return _TRIL[key]


def cholesky_factor(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with ``L @ L.T = a`` for SPD ``a`` (..., n, n).

    No pivoting; the diagonal is floored at 1e-12 before its square root."""
    n = a.shape[-1]
    cols = []
    work = a
    for _ in range(n):
        d = torch.sqrt(torch.clamp(work[..., 0, 0], min=_FLOOR))
        col = work[..., :, 0] / d[..., None]
        cols.append(col)
        below = col[..., 1:]
        work = work[..., 1:, 1:] - below[..., :, None] * below[..., None, :]
    packed = torch.cat(cols + [a.new_zeros(a.shape[:-2] + (1,))], dim=-1)
    return packed[..., _tril_index(n, a.device)].unflatten(-1, (n, n))


def _solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L y = b`` by forward substitution over the columns of L."""
    n = l.shape[-1]
    ys = []
    r = b
    for j in range(n):
        yj = r[..., 0] / l[..., j, j]
        ys.append(yj)
        r = r[..., 1:] - l[..., j + 1:, j] * yj[..., None]
    return torch.stack(ys, dim=-1)


def _solve_upper_t(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``L^T x = y`` by backward substitution over the rows of L."""
    n = l.shape[-1]
    xs = []
    r = y
    for j in reversed(range(n)):
        xj = r[..., j] / l[..., j, j]
        xs.append(xj)
        r = r[..., :j] - l[..., j, :j] * xj[..., None]
    return torch.stack(xs[::-1], dim=-1)


def cholesky_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` given a factor from :func:`cholesky_factor`."""
    return _solve_upper_t(l, _solve_lower(l, b))


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system ``a x = b``: (..., n, n) and (..., n)."""
    return cholesky_solve(cholesky_factor(a), b)
