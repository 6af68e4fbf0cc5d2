"""The port's on-device generators (``data/device.py``) against the JAX
package's ``data/device.py``.

``torch.Generator`` and ``jax.random`` give different bits, so the tests
compare what both promise: every row strictly inside the unit ball (its
exact norm, computed in f64 from the stored values, at most 1), labels +-1,
separable labels that agree with the ground truth, and the same moments
(component mean and variance, share of rows shorter than the clip, label
mean, flip rate) within a few standard errors.
"""

import jax
import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.data import device as jax_device
from online_convex_optimization_tpu_torch.data import device
from online_convex_optimization_tpu_torch.ops import game

torch.set_num_threads(1)

B, T, D = 256, 64, 5
STRICT = 1.0 - 2e-6
# 16,384 rows of 5 components: the standard error of a difference of two
# component means is ~0.002, of two shares of short rows ~0.002, of two
# label means (16,384 labels each) ~0.011.  Bounds are four to seven of
# them.
MOMENT_TOL = {"mean": 0.015, "var": 0.015, "short": 0.015,
              "label_mean": 0.05}


def _gen(seed=0):
    return torch.Generator(device="cpu").manual_seed(seed)


def _moments(z, y):
    """Per-row statistics of ``(rows, d)`` z and its labels, in f64."""
    z = np.asarray(z, dtype=np.float64).reshape(-1, D)
    nsq = np.sum(z * z, axis=-1)
    return {"mean": float(z.mean()),
            "var": float(z.var()),
            "short": float(np.mean(nsq < STRICT ** 2 * (1 - 1e-6))),
            "label_mean": float(np.asarray(y, dtype=np.float64).mean())}


def _assert_contract(z_rows, y):
    z64 = np.asarray(z_rows, dtype=np.float64)
    assert float(np.max(np.sum(z64 * z64, axis=-1))) <= 1.0
    assert set(np.unique(np.asarray(y))) <= {-1.0, 1.0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_game_batch_is_strict_and_matches_jax_moments(dtype):
    z, y = device.random_game_batch(_gen(1), B, T, D, dtype=dtype)
    assert z.shape == (B, T, D) and y.shape == (B, T)
    assert z.dtype == y.dtype == dtype and z.device.type == "cpu"
    _assert_contract(z.numpy().reshape(-1, D), y.numpy())
    assert game.in_contract(z, y, torch.full((B,), T, dtype=torch.int32))
    zj, yj = jax_device.random_game_batch(jax.random.key(1), B, T, D)
    got, want = _moments(z.numpy(), y.numpy()), _moments(zj, yj)
    for key in want:
        assert abs(got[key] - want[key]) <= MOMENT_TOL[key], (key, got, want)


def test_random_time_major_batch_layout_and_moments():
    z, y = device.random_time_major_batch(_gen(2), T, B, D)
    assert z.shape == (T, D, B) and y.shape == (T, B)
    rows = z.permute(0, 2, 1).reshape(-1, D).numpy()      # norms along dim 1
    _assert_contract(rows, y.numpy())
    game.validate_stream_chunk(z, y)
    zb, yb = device.random_game_batch(_gen(3), B, T, D)
    got, want = _moments(rows, y.numpy()), _moments(zb.numpy(), yb.numpy())
    for key in want:
        assert abs(got[key] - want[key]) <= MOMENT_TOL[key], (key, got, want)


@pytest.mark.parametrize("noise_p", [0.0, 0.2])
def test_separable_stream_batch_labels_and_flip_rate(noise_p):
    z, y, u = device.separable_stream_batch(_gen(4), B, T, D, noise_p)
    assert z.shape == (B, T, D) and y.shape == (B, T) and u.shape == (B, D)
    _assert_contract(z.numpy().reshape(-1, D), y.numpy())
    np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=-1), 1.0,
                               rtol=0, atol=1e-6)
    truth = np.where(np.einsum("btd,bd->bt", z.numpy().astype(np.float64),
                               u.numpy().astype(np.float64)) >= 0, 1.0, -1.0)
    flipped = float(np.mean(y.numpy() != truth))
    zj, yj, uj = jax_device.separable_stream_batch(jax.random.key(4), B, T, D,
                                                   noise_p)
    truth_j = np.where(np.einsum("btd,bd->bt", np.asarray(zj, np.float64),
                                 np.asarray(uj, np.float64)) >= 0, 1.0, -1.0)
    flipped_j = float(np.mean(np.asarray(yj) != truth_j))
    if noise_p == 0.0:
        # Rows within an ulp of the separating plane may round either way.
        assert flipped <= 1e-3 and flipped_j <= 1e-3
    else:
        assert abs(flipped - noise_p) <= MOMENT_TOL["short"]
        assert abs(flipped - flipped_j) <= MOMENT_TOL["short"]


def test_generators_are_reproducible_and_shards_independent():
    a = device.random_game_batch(_gen(7), 8, 16)
    b = device.random_game_batch(_gen(7), 8, 16)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    gens = device.shard_generators(11, 3)
    assert len(gens) == 3
    draws = [device.random_game_batch(g, 8, 16)[0] for g in gens]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])
    again = device.random_game_batch(device.shard_generators(11, 3)[1], 8, 16)
    assert torch.equal(again[0], draws[1])


def test_rejects_other_dtypes():
    with pytest.raises(TypeError):
        device.random_game_batch(_gen(), 2, 2, dtype=torch.float16)
    with pytest.raises(TypeError):
        device.random_time_major_batch(_gen(), 2, 2, dtype=torch.int32)
