"""On-device sequence generation (``torch.Generator``): the throughput path.

Counterpart of ``online_convex_optimization_tpu/data/device.py``.  The
host-NumPy builders in ``sequences.py`` reproduce the reference's PCG64
streams for parity runs; these functions draw the same *distributions*
directly on the generator's device, for runs too large to feed from the
host:

  - g(T)-style instances: Gaussian rows clipped into the unit ball +
    Rademacher labels (``random_game_batch``);
  - separable / Massart-noise streams with per-sequence ground truths
    (``separable_stream_batch``);
  - the quadratic track's regression streams
    (``regression_stream_batch``);
  - direct generation in the kernels' time-major ``(T, d, B)`` layout
    (``random_time_major_batch``, the counterpart of
    ``random_packed_batch``'s packed TPU layout), which the wrappers and
    ``StreamingKernelGame.feed_packed`` take with no reshuffling.

The generator decides the device.  Bits differ from ``jax.random``'s (and
between devices); the distributions are the same.

The game generators take the storage pairs of ``ops/game.py::STORAGE``:
``dtype=torch.bfloat16`` and ``y_dtype=torch.int8``, as the JAX
``random_packed_batch(dtype, y_dtype)`` stores them.  bf16 rows are drawn
and clipped in float32 with a deflation of 1 - 2^-8 (``_STRICT_BF16``) and
then rounded: bf16 rounding moves a component by at most 2^-9 of itself, so
every stored row keeps a float32 norm at most 1 and the generated games
stay in the identity's contract.  (The JAX package deflates bf16 rows by
``_STRICT`` only, so some of its rounded rows lie just outside the ball.)
Labels are drawn as int8 and stored in ``y_dtype``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from online_convex_optimization_tpu_torch.ops.actions import sum_last
from online_convex_optimization_tpu_torch.ops.game import (
    compute_dtype,
    storage_suffix,
)

# Strict-ball deflation (the JAX package's _STRICT): a plain clip
# z / max(||z||, 1) leaves rounded rows whose exact norms exceed 1 by ~1e-7
# in f32.  Scaling by 1 - 2e-6, well above f32's worst-case rounding
# inflation of norm, divide and per-component rounding, keeps every row's
# exact norm <= 1, so the hinge identity is exact on every prefix.
_STRICT = 1.0 - 2e-6

# The bf16 rows' deflation: (1 - 2^-8) (1 + 2^-9) < 1 - 2^-9, far below 1
# after float32's own rounding of the clip and of the norm.
_STRICT_BF16 = 1.0 - 2.0 ** -8

_FLOATS = (torch.float32, torch.float64)


def _check_dtype(dtype) -> None:
    if dtype not in _FLOATS:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")


def _storage(dtype, y_dtype):
    """Validate a (z, y) storage pair; return ``(draw dtype, y dtype)``: the
    dtype the rows are drawn and clipped in, and the labels' storage."""
    y_dtype = dtype if y_dtype is None else y_dtype
    storage_suffix(dtype, y_dtype)
    return compute_dtype(dtype), y_dtype


def _clip_rows(z: torch.Tensor, dim: int = -1,
               strict: float = _STRICT) -> torch.Tensor:
    """Strict clip of every row (along ``dim``) into the unit ball."""
    norms = torch.sqrt(torch.sum(z * z, dim=dim, keepdim=True))
    return z * (strict / torch.clamp(norms, min=1.0))


def _stored_rows(z: torch.Tensor, dtype, dim: int = -1) -> torch.Tensor:
    """Rows drawn in the compute dtype, clipped for their storage ``dtype``
    and stored in it."""
    if dtype == torch.bfloat16:
        return _clip_rows(z, dim, _STRICT_BF16).to(dtype)
    return _clip_rows(z, dim)


def _rademacher(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device, dtype=torch.int8)
    return (2 * bits - 1).to(dtype)


def random_game_batch(generator: torch.Generator, B: int, T: int,
                      d: int = 5, *, dtype=torch.float32, y_dtype=None):
    """g(T)-style batch on ``generator.device``: ``(B, T, d)`` z with rows
    strictly in the unit ball, ``(B, T)`` labels +-1, stored in ``dtype``
    and ``y_dtype`` (default ``dtype``)."""
    draw, y_dtype = _storage(dtype, y_dtype)
    z = _stored_rows(torch.randn((B, T, d), generator=generator,
                                 device=generator.device, dtype=draw), dtype)
    return z, _rademacher(generator, (B, T), y_dtype)


def separable_stream_batch(generator: torch.Generator, B: int, T: int,
                           d: int = 5, noise_p: float = 0.0, *,
                           dtype=torch.float32, y_dtype=None):
    """Separable (optionally Massart-noisy) streams: returns ``(z, y, u)``
    with unit ground truths ``u (B, d)`` in the compute dtype, ``y =
    sign(<z_t, u>)`` (+1 at 0) of the stored rows, each label flipped with
    probability ``noise_p``; z and y stored in ``dtype`` and ``y_dtype``
    (default ``dtype``)."""
    draw, y_dtype = _storage(dtype, y_dtype)
    dev = generator.device
    u = torch.randn((B, d), generator=generator, device=dev, dtype=draw)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-30)
    z = _stored_rows(torch.randn((B, T, d), generator=generator, device=dev,
                                 dtype=draw), dtype)
    # An elementwise product and an index-order sum: no TF32 matmul.
    q = sum_last(z.to(draw) * u[:, None, :])
    y = torch.where(q >= 0.0, 1.0, -1.0).to(y_dtype)
    if noise_p > 0.0:
        flips = torch.rand((B, T), generator=generator, device=dev) < noise_p
        y = torch.where(flips, -y, y)
    return z, y, u


def regression_stream_batch(generator: torch.Generator, B: int, T: int,
                            d: int = 5, sigma: float = 0.1, *,
                            dtype=torch.float32):
    """Quadratic-track regression streams, the device twin of
    ``sequences.make_regression_stream``: returns ``(z, y, u)`` with unit
    ground truths ``u (B, d)``, rows strictly in the unit ball and real
    targets ``y = <z_t, u> + sigma * N(0, 1)``."""
    _check_dtype(dtype)
    dev = generator.device
    u = torch.randn((B, d), generator=generator, device=dev, dtype=dtype)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-30)
    z = _clip_rows(torch.randn((B, T, d), generator=generator, device=dev,
                               dtype=dtype))
    noise = torch.randn((B, T), generator=generator, device=dev, dtype=dtype)
    return z, sum_last(z * u[:, None, :]) + sigma * noise, u


def random_time_major_batch(generator: torch.Generator, T: int, B: int,
                            d: int = 5, *, dtype=torch.float32,
                            y_dtype=None):
    """Generate directly in the kernels' time-major layout: ``(T, d, B)``
    z (rows along dim 1, strictly in the unit ball) and ``(T, B)`` labels
    +-1, stored in ``dtype`` and ``y_dtype`` (default ``dtype``).
    ``z.permute(2, 0, 1)`` is the ``(B, T, d)`` view the batch APIs take;
    their repack to time-major is then free."""
    draw, y_dtype = _storage(dtype, y_dtype)
    z = _stored_rows(torch.randn((T, d, B), generator=generator,
                                 device=generator.device, dtype=draw),
                     dtype, dim=1)
    return z, _rademacher(generator, (T, B), y_dtype)


def shard_generators(seed: int, n_shards: int,
                     device="cpu") -> List[torch.Generator]:
    """Independent generators, one per shard (the counterpart of
    ``shard_keys``), seeded from ``numpy.random.SeedSequence(seed).spawn``."""
    children = np.random.SeedSequence(seed).spawn(n_shards)
    return [torch.Generator(device=device).manual_seed(
        int(c.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        for c in children]
