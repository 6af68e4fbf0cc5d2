"""The premises of K5's and K6's Hopper designs, shown on the CPU.

K6 (``csrc/smart_sweep_kernel.cu``) splits the SMART threshold sweep into a
prefix once per sequence (K6a: the FTL track with one action a round, a
pointer over the sorted thresholds) and the FTRL tails of the pairs that
switched (K6b, from the FTL losses at the switch).  Its plain mirror,
``ops/smart.py::smart_sweep_split_reference``, equals
``smart_sweep_reference`` bit for bit: ragged lengths (0 among them),
unsorted and duplicate thresholds, thresholds that never fire, fire at
round 0 or on the last valid round, and replay mode; the pointer's switch
rounds are each threshold's first crossing; the z = e1 tie families agree
with the golden copy and the JAX package in x64.

K5 (``csrc/sweep_kernel.cu``) reads each round's FTRL scale from the
``(E, T)`` table ``ops/game.py::sweep_scales`` and keeps ``w`` once per
sequence: a mirror that does so equals ``eta_sweep_reference`` bit for bit.

Every comparison with the port's own plain versions is exact.
"""

import math

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.models.sweep_api import (
    smart_threshold_sweep as jax_threshold_sweep,
)
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    ftrl_action_scaled,
    sum_last,
)
from online_convex_optimization_tpu_torch.ops.hinge import (
    hinge_subgradient,
    normalized_hinge,
)
from online_convex_optimization_tpu_torch.testing.golden import (
    golden_simulate_smart,
)

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
ETA = math.sqrt(2.0)


def _batch(B, T, d, seed, dtype, *, contract=True):
    """Rows in the unit ball with labels +-1 (or, outside the contract,
    larger rows and real labels); lengths uniform in [0, T] with T, 0 and
    1 among them."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        z *= 1.5
        y = rng.normal(size=(B, T))
    lengths = rng.integers(0, T + 1, size=B)
    lengths[:3] = (T, 0, 1)
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _leads(z, y, lengths):
    """The lead F - L_t of every round (``(B, T)``, NaN past a sequence's
    length), from the FTL track with its action computed twice a round, as
    K2 computes it."""
    B, T, d = z.shape
    theta = z.new_zeros((B, d))
    w = z.new_zeros((B, d))
    F = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    out = torch.full((B, T), math.nan, dtype=z.dtype)
    for t in range(T):
        valid = lengths > t
        v = valid.to(z.dtype)
        z_t, y_t = z[:, t], y[:, t]
        q = sum_last(z_t * ftl_action(theta))
        theta = theta + (v * hinge_subgradient(q, y_t))[:, None] * z_t
        F = F + v * normalized_hinge(q, y_t)
        w = w + (v * y_t)[:, None] * z_t
        cnt = cnt + v
        lead = F - 0.5 * (cnt - sum_last(ftl_action(theta) * w))
        out[:, t] = torch.where(valid, lead, math.nan)
    return out


def _first_crossing(leads, threshold, T):
    """The first round with lead >= threshold, T where there is none."""
    hit = leads >= threshold
    first = torch.argmax(hit.to(torch.int64), dim=1)
    return torch.where(hit.any(dim=1), first, torch.full_like(first, T))


def _thresholds(dtype):
    """Unsorted, with a duplicate, one that never fires, one that fires at
    round 0 and one (2.5) that some sequence crosses on its last valid
    round (``_with_last_round_crossing``)."""
    return torch.tensor([6.0, 1.0, 1e9, 2.5, -1e9, 2.5, 0.7, 10.0],
                        dtype=dtype)


def _with_last_round_crossing(z, y, lengths, threshold):
    """Cut sequence 3 to end at its first crossing of ``threshold``."""
    T = z.shape[1]
    full = torch.full_like(lengths, T)
    tau = _first_crossing(_leads(z, y, full), threshold, T)
    assert int(tau[3]) < T, "sequence 3 must cross the threshold"
    lengths = lengths.clone()
    lengths[3] = int(tau[3]) + 1
    return lengths


# ------------------------------------------------------------------- K6

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("contract", [True, False])
def test_split_reference_equals_sweep_reference(dtype, contract):
    z, y, lengths = _batch(40, 90, 5, 1, dtype, contract=contract)
    ths = _thresholds(dtype)
    lengths = _with_last_round_crossing(z, y, lengths, 2.5)
    eta = torch.tensor(ETA, dtype=dtype)
    want, want_tau = smart.smart_sweep_reference(z, y, ths, eta, lengths,
                                                 replay=not contract)
    got, tau = smart.smart_sweep_split_reference(z, y, ths, eta, lengths,
                                                 replay=not contract)
    assert torch.equal(got, want) and torch.equal(tau, want_tau)
    # The premises the data must exercise.
    assert bool((tau[:, 2] == 90).all())                  # never fires
    valid = lengths > 0
    assert bool((tau[valid, 4] == 0).all())               # fires at round 0
    assert int(tau[3, 3]) == int(lengths[3]) - 1          # on the last round
    assert torch.equal(tau[:, 3], tau[:, 5])              # duplicates
    assert bool((tau[1] == 90).all())                     # length 0
    tail = tau + 1 < lengths[:, None].to(torch.int64)
    assert bool(tail.any()) and not bool(tail.all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_reference_at_generic_d_and_one_threshold(dtype):
    z, y, lengths = _batch(33, 70, 3, 2, dtype)
    eta = torch.tensor(0.8, dtype=dtype)
    ths = torch.tensor([1.5], dtype=dtype)
    want = smart.smart_sweep_reference(z, y, ths, eta, lengths)
    got = smart.smart_sweep_split_reference(z, y, ths, eta, lengths)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pointer_switch_rounds_are_first_crossings(dtype):
    z, y, lengths = _batch(40, 90, 5, 3, dtype)
    ths = _thresholds(dtype)
    _, tau, _ = smart.smart_prefix_reference(z, y, ths, lengths)
    leads = _leads(z, y, lengths)
    for g in range(len(ths)):
        assert torch.equal(tau[:, g], _first_crossing(leads, ths[g], 90))


def test_prefix_leaves_the_final_regret_where_there_is_no_tail():
    """K6a's output is final for every pair without a tail, and the tail's
    starting sum (the FTL losses at the switch) for the others."""
    z, y, lengths = _batch(40, 90, 5, 4, torch.float64)
    ths = _thresholds(torch.float64)
    eta = torch.tensor(ETA, dtype=torch.float64)
    partial, tau, _ = smart.smart_prefix_reference(z, y, ths, lengths)
    want, _ = smart.smart_sweep_reference(z, y, ths, eta, lengths)
    tail = tau + 1 < lengths[:, None].to(torch.int64)
    assert torch.equal(partial[~tail], want[~tail])
    assert not torch.equal(partial[tail], want[tail])


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
@pytest.mark.parametrize("T", [200, 800])
def test_split_reference_on_tie_families_matches_golden_and_jax(title, T):
    z, y, _ = CASES[title](run_seed=2025)(T)
    z, y = z.astype(np.float64), y.astype(np.float64)
    thr = math.sqrt(2.0 * T)
    zt = torch.as_tensor(z[None], dtype=torch.float64)
    yt = torch.as_tensor(y[None], dtype=torch.float64)
    reg, tau = smart.smart_sweep_split_reference(
        zt, yt, torch.tensor([thr], dtype=torch.float64),
        torch.tensor(ETA, dtype=torch.float64),
        torch.tensor([T], dtype=torch.int32))
    want, want_tau = golden_simulate_smart(z, y, thr, ETA,
                                           return_switch=True)
    assert abs(float(reg[0, 0]) - want) <= 1e-9
    assert min(int(tau[0, 0]), T) == want_tau
    jax_reg = np.asarray(jax_threshold_sweep(z[None], y[None], [thr],
                                             eta0=ETA, use_kernel=False))
    assert abs(float(reg[0, 0]) - float(jax_reg[0, 0])) <= 1e-9


# ------------------------------------------------------------------- K5

def _k5_table_mirror(z, y, scales, lengths, *, replay=False):
    """K5's design in plain PyTorch: each round's scale from the ``(E, T)``
    table, one FTRL action a round, w once per sequence."""
    B, T, d = z.shape
    E = scales.shape[0]
    dtype = z.dtype
    theta = z.new_zeros((B, E, d))
    w = z.new_zeros((B, d))
    cum = z.new_zeros((B, E))
    T_run = int(lengths.max())
    for t in range(T_run):
        v = (lengths > t).to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        x = ftrl_action_scaled(theta, scales[:, t][None, :])
        q = sum_last(z_t[:, None, :] * x)
        cum = cum + v[:, None] * normalized_hinge(q, y_t[:, None])
        theta = theta + (v[:, None] * hinge_subgradient(q, y_t[:, None])
                         )[..., None] * z_t[:, None, :]
        w = w + (v * y_t)[:, None] * z_t
    x_c = ftl_action(theta)
    if replay:
        comp = z.new_zeros((B, E))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v[:, None] * normalized_hinge(
                sum_last(z[:, t][:, None, :] * x_c), y[:, t][:, None])
    else:
        comp = 0.5 * (lengths.to(dtype)[:, None] -
                      sum_last(x_c * w[:, None, :]))
    return cum - comp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("contract", [True, False])
def test_k5_table_mirror_equals_eta_sweep_reference(dtype, contract):
    z, y, lengths = _batch(37, 81, 5, 5, dtype, contract=contract)
    grid = torch.tensor([0.05, 0.4, 1.0, ETA, 2.9, 4.0], dtype=dtype)
    want = game.eta_sweep_reference(z, y, grid, lengths, replay=not contract)
    got = _k5_table_mirror(z, y, game.sweep_scales(grid, 81), lengths,
                           replay=not contract)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scale_table_rows_are_the_round_scales(dtype):
    """Row e of the table is ``ftrl_scales`` at eta_e (K3's table) and
    entry t - 1 is the scale ``ftrl_action`` forms at round t."""
    grid = torch.tensor([0.05, 0.3, ETA, 4.0], dtype=dtype)
    T = 3000
    table = game.sweep_scales(grid, T)
    assert table.shape == (4, T) and table.dtype == dtype
    one = torch.ones((1, 1), dtype=dtype)
    for e in range(4):
        assert torch.equal(table[e], game.ftrl_scales(
            T, float(grid[e]), dtype=dtype, device="cpu"))
        for t in (1, 2, 3, 97, 1000, T):
            assert torch.equal(ftrl_action_scaled(one, table[e, t - 1]),
                               ftrl_action(one, t, grid[e]))


def test_length_order():
    lengths = torch.tensor([5, 9, 0, 9, 7, 5], dtype=torch.int32)
    order = game.length_order(lengths)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 4, 0, 5, 2]
