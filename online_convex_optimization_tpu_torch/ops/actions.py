"""Action rules and norm-ball projections.

Counterpart of ``online_convex_optimization_tpu/ops/actions.py``
(``ftl_action``, ``ftrl_action``, ``project_l2_ball``, ``project_linf_ball``,
``project_l1_ball``); reference fast_algorithms.py:37-66 and
exact_ftl.py:96-100.  All functions act on the trailing axis.

Order of operations is part of the contract.  The ``z = e1`` families reach
exact ties ``q == y``, and one ulp in an action flips a tie subgradient, so
every step is written as the reference writes it: a true division by a
correctly rounded ``torch.sqrt`` (``torch.reciprocal`` is a correctly
rounded ``1/x``, and ``-1/x == -(1/x)`` exactly), never a fused
reciprocal square root nor ``number / tensor`` (which PyTorch computes as
``number * reciprocal(tensor)``), and squared norms summed over the trailing axis in
index order (``sum_last``) — the order the CUDA kernels use, so the plain
PyTorch versions and the kernels agree bit for bit.
"""

from __future__ import annotations

import torch


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing axis in index order: ``((x0 + x1) + x2) + ...``."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _inv_sqrt(norm_sq: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(norm_sq)`` as a true division (``1`` where ``norm_sq <= 0``,
    which callers mask out)."""
    safe = torch.where(norm_sq > 0.0, norm_sq, torch.ones_like(norm_sq))
    return torch.reciprocal(torch.sqrt(safe))


def ftl_action(theta: torch.Tensor) -> torch.Tensor:
    """Linearized follow-the-leader action ``-theta/||theta||``, the zero
    vector at ``theta == 0`` (fast_algorithms.py:37-49)."""
    norm_sq = sum_last(theta * theta)[..., None]
    scale = torch.where(norm_sq > 0.0, -_inv_sqrt(norm_sq), 0.0)
    return scale * theta


def ftrl_action(theta: torch.Tensor, t, eta0) -> torch.Tensor:
    """FTRL action ``-(eta0/sqrt(max(1, t))) * theta``, rescaled by
    ``1/sqrt(||x||^2)`` iff ``||x||^2 > 1`` (fast_algorithms.py:52-66).

    ``t`` is the 1-based round index and ``eta0`` the step scale, each a
    scalar or one value per leading index of ``theta``.
    """
    t = torch.as_tensor(t, dtype=theta.dtype, device=theta.device)
    eta0 = torch.as_tensor(eta0, dtype=theta.dtype, device=theta.device)
    return ftrl_action_scaled(
        theta, -torch.div(eta0, torch.sqrt(torch.clamp(t, min=1.0))))


def ftrl_action_scaled(theta: torch.Tensor, scale) -> torch.Tensor:
    """FTRL action for a given round scale: ``scale * theta``, rescaled by
    ``1/sqrt(||x||^2)`` iff ``||x||^2 > 1``.  ``scale`` is a scalar or one
    value per leading index of ``theta`` (kernel K3 reads it from a
    table)."""
    scale = torch.as_tensor(scale, dtype=theta.dtype, device=theta.device)
    if scale.ndim == theta.ndim - 1:
        scale = scale[..., None]
    x = scale * theta
    norm_sq = sum_last(x * x)[..., None]
    factor = torch.where(norm_sq > 1.0, _inv_sqrt(norm_sq), 1.0)
    return x * factor


def project_l2_ball(x: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Euclidean projection onto ``{x : ||x||_2 <= radius}``."""
    norm_sq = sum_last(x * x)[..., None]
    safe = torch.where(norm_sq > 0.0, norm_sq, torch.ones_like(norm_sq))
    # A Python number over a tensor multiplies by the reciprocal; the
    # reference divides.
    factor = torch.where(norm_sq > radius * radius,
                         torch.full_like(norm_sq, radius) / torch.sqrt(safe),
                         1.0)
    return x * factor


def project_linf_ball(x: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Projection onto ``{x : ||x||_inf <= radius}`` (coordinate clamp)."""
    return torch.clamp(x, -radius, radius)


def project_l1_ball(x: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Euclidean projection onto ``{x : ||x||_1 <= radius}``: sort-based
    simplex projection (Duchi et al. 2008), soft-thresholding by the largest
    multiplier that keeps the l1 mass at ``radius``."""
    abs_x = torch.abs(x)
    inside = abs_x.sum(dim=-1, keepdim=True) <= radius
    u = torch.sort(abs_x, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - radius
    d = x.shape[-1]
    idx = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
    cond = u - css / idx > 0.0
    # rho = largest index where cond holds (cond is a prefix property).
    rho = torch.clamp(cond.sum(dim=-1, keepdim=True), min=1)
    theta = torch.gather(css, -1, rho - 1) / rho.to(x.dtype)
    shrunk = torch.sign(x) * torch.clamp(abs_x - theta, min=0.0)
    return torch.where(inside, x, shrunk)
