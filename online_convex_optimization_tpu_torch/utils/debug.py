"""Numerical-safety utilities for sweeps.

Counterpart of ``online_convex_optimization_tpu/utils/debug.py``:

  - ``finite_or_sentinel``: per-element failure containment for sweeps: a
    diverged scenario becomes a sentinel the aggregation can drop, instead
    of poisoning a cross-rank reduction (``parallel/sweep.py``);
  - ``drop_nonfinite_stats``: ``(n_valid, max, mean)`` over the finite
    entries of a regret vector;
  - ``checked``: the JAX package wraps a function with checkify, which has
    no PyTorch counterpart.  Here it is an explicit guard: every tensor the
    function returns is tested with ``torch.isfinite`` and a non-finite one
    raises ``FloatingPointError`` naming it (``assert_finite``).  It checks
    the outputs, not each operation inside.

The JAX ``debug_nans`` (a scoped ``jax_debug_nans`` toggle that makes every
primitive raise on a NaN result) has no counterpart: PyTorch has no switch
that checks each operation's result, so the port offers none.
"""

from __future__ import annotations

import dataclasses
from functools import wraps

import torch


def finite_or_sentinel(x: torch.Tensor,
                       sentinel: float = float("nan")) -> torch.Tensor:
    """Replace non-finite entries of ``x`` by ``sentinel``."""
    return torch.where(torch.isfinite(x), x,
                       torch.as_tensor(sentinel, dtype=x.dtype,
                                       device=x.device))


def drop_nonfinite_stats(regrets: torch.Tensor):
    """``(n_valid, max, mean)`` over the finite entries of ``regrets``
    (``max`` is -inf and ``mean`` 0 when none is finite)."""
    finite = torch.isfinite(regrets)
    n = finite.sum()
    total = torch.where(finite, regrets, 0.0).sum()
    mx = torch.where(finite, regrets, float("-inf")).max()
    return n, mx, total / torch.clamp(n, min=1)


def assert_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """Return ``x``; raise ``FloatingPointError`` naming it if any entry is
    NaN or infinite (a device sync)."""
    if not bool(torch.isfinite(x).all()):
        bad = int((~torch.isfinite(x)).sum())
        raise FloatingPointError(f"{name}: {bad} of {x.numel()} entries are "
                                 f"not finite")
    return x


def _named_tensors(out, name: str):
    """``(name, tensor)`` for every floating tensor in ``out``: a tensor, a
    dataclass, a named tuple, a tuple or list, or a dict."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield name, out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _named_tensors(getattr(out, f.name), f"{name}.{f.name}")
    elif isinstance(out, tuple) and hasattr(out, "_fields"):
        for field, value in zip(out._fields, out):
            yield from _named_tensors(value, f"{name}.{field}")
    elif isinstance(out, (tuple, list)):
        for i, value in enumerate(out):
            yield from _named_tensors(value, f"{name}[{i}]")
    elif isinstance(out, dict):
        for key, value in out.items():
            yield from _named_tensors(value, f"{name}[{key!r}]")


def checked(fn):
    """Wrap ``fn`` so that a non-finite entry in any floating tensor it
    returns raises ``FloatingPointError`` with the tensor's name, e.g.
    ``simulate_linear_batch().regret``."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for name, tensor in _named_tensors(out, f"{fn.__name__}()"):
            assert_finite(tensor, name)
        return out

    return wrapper
