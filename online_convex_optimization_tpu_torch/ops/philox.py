"""Philox4x32-10, the counter-based bit generator of kernel K7.

The TPU kernel ``_synthetic_kernel`` draws its Rademacher rows from the
TPU's on-core PRNG (``pltpu.prng_random_bits``), whose bits no GPU can
reproduce.  The port draws them from Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011): ten rounds of two 32 x 32 ->
64-bit products and xors on a 128-bit counter under a 64-bit key.  The CUDA
kernel (``csrc/oco_philox.cuh``) and this plain version compute the same
function, so the kernel and its plain version see the same bits.

K7's use of it: the key is the 64-bit seed, the counter of round ``t``
(0-based) of sequence ``b`` is ``(t, b, k, 0)``, and call ``k`` gives bits
``128 k .. 128 k + 127`` of that round; bit ``j < d`` is the sign of
``z_j`` and bit ``d`` the sign of ``y`` (1 -> +, 0 -> -).  The stream thus
depends on (seed, b, t) only, never on the launch's shape or split.

The arithmetic is on int64 tensors holding 32-bit values: a 32 x 32-bit
product overflows int64, so each product is formed from the 16-bit halves
of the multiplier, whose partial products stay below 2^48.
"""

from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def mulhilo32(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` for int64 ``a`` in
    [0, 2^32) and a constant ``m`` < 2^32, exact in int64."""
    p = a * (m >> 16)                    # < 2^48
    q = a * (m & 0xFFFF)                 # < 2^48
    r = ((p & 0xFFFF) << 16) + q         # the low 48 bits' sum, < 2^49
    return (p >> 16) + (r >> 32), r & MASK32


def philox4x32_10(c0, c1, c2, c3, key: int):
    """Philox4x32-10 of the counter ``(c0, c1, c2, c3)`` (int64 tensors of
    32-bit values, broadcastable) under the 64-bit ``key``; returns the four
    32-bit output words as int64 tensors."""
    key &= (1 << 64) - 1
    k0, k1 = key & MASK32, key >> 32
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = mulhilo32(c0, PHILOX_M0)
        hi1, lo1 = mulhilo32(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def round_bits(seed: int, T: int, B: int, n_bits: int,
               device="cpu") -> torch.Tensor:
    """The first ``n_bits`` bits of every (round, sequence) of K7's stream:
    a ``(T, B, n_bits)`` int64 tensor of 0s and 1s on ``device``."""
    n_words = (n_bits + 127) // 128
    t = torch.arange(T, dtype=torch.int64, device=device)[:, None, None]
    b = torch.arange(B, dtype=torch.int64, device=device)[None, :, None]
    k = torch.arange(n_words, dtype=torch.int64, device=device)[None, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10(t & MASK32, b & MASK32, k, zero, seed),
                        dim=-1)                          # (T, B, K, 4)
    words = words.reshape(T, B, 4 * n_words)
    j = torch.arange(n_bits, dtype=torch.int64, device=device)
    return (words[..., j >> 5] >> (j & 31)) & 1
