"""The premises of K1's and K2's Hopper designs, shown on the CPU.

K1 (``csrc/regret_kernel.cu``) reads each round's FTRL scale from the
``(E, T)`` table of ``ops/game.py::eta_table`` and plays several flags of
one sequence from one copy of its rows (``regret_plays``); the main path
launches it once for the whole g(T) table and once a case.  K2
(``csrc/smart_kernel.cu``) plays the FTL track once for all the thresholds
of a sequence with one FTL action a round, and each switched pair's FTRL
tail from the FTL losses at its switch; ``ops/smart.py::
smart_plays_reference`` mirrors it.

Each premise is held bit for bit against the port's own plain versions:
the table's scale against ``ftrl_action`` (the z = e1 tie families
included), the plays against the doubled batch the parent launched, the
K2 mirror against ``smart_regrets_reference`` with integer thresholds at
T = 200 and 800 (and against the JAX package's SMART in x64 at 1e-9), the
one-launch ragged g(T) table against the per-horizon loop, and
``evaluate_stream_with_stats`` under the new launch geometry against
``batch_chunk=4096``.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.models.smart import (
    simulate_smart_batch as jax_smart_batch,
)
from online_convex_optimization_tpu_torch.data.sequences import (
    CASES,
    sample_g_batch,
)
from online_convex_optimization_tpu_torch.experiments import (
    evaluate as pt_evaluate,
)
from online_convex_optimization_tpu_torch.experiments.gt import estimate_g
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    ftrl_action_scaled,
    sum_last,
)
from online_convex_optimization_tpu_torch.testing.golden import (
    golden_simulate_alg,
    golden_simulate_smart,
)

torch.set_num_threads(1)

ETA = math.sqrt(2.0)


def _batch(B, T, d=5, seed=0, *, contract=True, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        z *= 1.5
        y = rng.normal(size=(B, T))
    lengths = rng.integers(0, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _family(title, T):
    z, y, _ = CASES[title](run_seed=2025)(T)
    return z, y


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------ the FTRL scale table

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_table_scale_equals_ftrl_action(dtype):
    """Every round's action from the table's scale equals ``ftrl_action``
    in every bit, projecting and not, for each row of the table."""
    etas = torch.tensor([ETA, 0.05, 0.3, 1.0, 2.5, 4.0], dtype=dtype)
    T = 1000
    table = game.sweep_scales(etas, T)
    rng = np.random.default_rng(1)
    theta = torch.as_tensor(rng.normal(size=(6, 5)) * 30.0, dtype=dtype)
    for t in range(1, T + 1):
        want = ftrl_action(theta, t, etas)
        assert torch.equal(ftrl_action_scaled(theta, table[:, t - 1]), want)


def test_eta_table_rows_are_each_sequence_eta():
    """``eta_table``: one row for a scalar, a row a distinct value for a
    vector, each sequence's index naming its own eta's row."""
    scales, eidx = game.eta_table(ETA, 7, 50, torch.float64, "cpu")
    assert scales.shape == (1, 50) and bool((eidx == 0).all())
    etas = torch.tensor([0.5, 2.0, 0.5, 1.0, 2.0, 0.7, 0.5],
                        dtype=torch.float64)
    scales, eidx = game.eta_table(etas, 7, 50, torch.float64, "cpu")
    assert scales.shape == (4, 50) and eidx.dtype == torch.int32
    assert torch.equal(scales[eidx.long()], game.sweep_scales(etas, 50))


def _k1_table_mirror(z, y, flag, lengths):
    """K1's round with the FTRL scale read from the table, in the kernel's
    order: one sequence batch, one flag."""
    B, T, d = z.shape
    scales, eidx = game.eta_table(ETA, B, T, z.dtype, z.device)
    theta = z.new_zeros((B, d))
    w = z.new_zeros((B, d))
    cum = z.new_zeros((B,))
    for t in range(T):
        v = (lengths > t).to(z.dtype)
        x = (ftrl_action_scaled(theta, scales[eidx.long(), t]) if flag == 0
             else ftl_action(theta))
        theta, cum = game.hinge_round(theta, cum, x, z[:, t], y[:, t], v)
        w = w + (v * y[:, t])[:, None] * z[:, t]
    comp = 0.5 * (lengths.to(z.dtype) - sum_last(ftl_action(theta) * w))
    return cum, comp


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
@pytest.mark.parametrize("T", [200, 800])
def test_table_mirror_on_tie_families(title, T):
    """The z = e1 families reach exact ties q == y: K1's game with the
    table's scale equals ``regrets_fused_reference`` and the golden
    oracle."""
    z, y = _family(title, T)
    zt = torch.as_tensor(z[None], dtype=torch.float64)
    yt = torch.as_tensor(y[None], dtype=torch.float64)
    lengths = torch.tensor([T], dtype=torch.int32)
    for flag in (0, 1):
        cum, comp = _k1_table_mirror(zt, yt, flag, lengths)
        want = game.regrets_fused_reference(
            zt, yt, torch.tensor([flag]), torch.tensor([ETA],
                                                       dtype=torch.float64),
            lengths)
        _equal((cum, comp), want[:2])
        assert abs(float(cum - comp) - golden_simulate_alg(z, y, flag, ETA)
                   ) <= 1e-9


# ----------------------------------------------------- K1: plays of a launch

@pytest.mark.parametrize("d,contract", [(5, True), (3, True), (5, False)])
def test_plays_equal_the_doubled_batch(d, contract):
    """FTRL and FTL as two plays of one copy of z equal the parent's launch
    on the doubled batch, row for row; the wrapper's P = 1 entry equals the
    plain version."""
    z, y, lengths = _batch(40, 60, d, seed=d, contract=contract)
    replay = not game.in_contract(z, y, lengths)
    got = game.regret_plays(z, y, (game.ALG_FTRL, game.ALG_FTL), ETA,
                            lengths, replay)
    flags = torch.tensor([0] * 40 + [1] * 40)
    want = game.regrets_fused(torch.cat([z, z]), torch.cat([y, y]), flags,
                              ETA, torch.cat([lengths, lengths]))
    _equal([g.reshape(w.shape) for g, w in zip(got, want)], want)


# ------------------------------------------------------ K2: the plain mirror

@pytest.mark.parametrize("T", [200, 800])
@pytest.mark.parametrize("contract", [True, False])
def test_smart_mirror_equals_reference(T, contract):
    """One FTL action a round, the FTL track once for three thresholds
    (integers among them: ``lead >= threshold`` holds with equality at
    T = 200 and 800), tails from F: each row equals
    ``smart_regrets_reference`` in every bit."""
    z, y, lengths = _batch(24, T, seed=T, contract=contract)
    lengths[1] = 0
    ths = torch.stack([torch.full((24,), 2.0, dtype=torch.float64),
                       torch.sqrt(2.0 * lengths.double()),
                       torch.full((24,), float(T) / 20.0,
                                  dtype=torch.float64)])
    eta = torch.full((24,), ETA, dtype=torch.float64)
    got = smart.smart_plays_reference(z, y, ths, eta, lengths,
                                      replay=not contract)
    switched = 0
    for g in range(3):
        want = smart.smart_regrets_reference(z, y, ths[g], eta, lengths,
                                             replay=not contract)
        _equal((got[0][g], got[1], got[2][g], got[3][g]), want)
        switched += int((want[3] < T).sum())
    assert 0 < switched < 3 * 23


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
@pytest.mark.parametrize("T", [200, 800])
def test_smart_mirror_on_tie_families(title, T):
    """The deterministic families with the integer thresholds sqrt(2T)
    (20 and 40) and 10: the mirror equals ``smart_regrets_reference`` in
    every bit and the golden oracle's regret and switch round."""
    z, y = _family(title, T)
    zt = torch.as_tensor(z[None], dtype=torch.float64)
    yt = torch.as_tensor(y[None], dtype=torch.float64)
    lengths = torch.tensor([T], dtype=torch.int32)
    eta = torch.tensor([ETA], dtype=torch.float64)
    ths = torch.tensor([[math.sqrt(2.0 * T)], [10.0]], dtype=torch.float64)
    got = smart.smart_plays_reference(zt, yt, ths, eta, lengths)
    for g in range(2):
        want = smart.smart_regrets_reference(zt, yt, ths[g], eta, lengths)
        _equal((got[0][g], got[1], got[2][g], got[3][g]), want)
        golden, golden_tau = golden_simulate_smart(
            z, y, float(ths[g, 0]), ETA, return_switch=True)
        assert abs(float(got[0][g, 0] - got[1][0]) - golden) <= 1e-9
        assert min(int(got[3][g, 0]), T) == golden_tau


@pytest.mark.parametrize("d,contract", [(5, True), (3, False)])
def test_smart_mirror_matches_jax_x64(d, contract):
    """Against the JAX package's SMART scan in x64, each threshold row."""
    z, y, lengths = _batch(48, 80, d, seed=20 + d, contract=contract)
    lengths = lengths.clamp(min=1)
    ths = np.stack([np.sqrt(2.0 * lengths.numpy()), np.full(48, 1.75)])
    eta = np.full(48, ETA)
    got = smart.smart_plays_reference(
        z, y, torch.as_tensor(ths), torch.as_tensor(eta), lengths,
        replay=not contract)
    for g in range(2):
        want = jax_smart_batch(jnp.asarray(z.numpy()), jnp.asarray(y.numpy()),
                               jnp.asarray(ths[g]), jnp.asarray(eta),
                               jnp.asarray(lengths.numpy()))
        np.testing.assert_allclose(got[0][g].numpy(),
                                   np.asarray(want.cum_loss), atol=1e-9)
        np.testing.assert_allclose((got[0][g] - got[1]).numpy(),
                                   np.asarray(want.regret), atol=1e-9)
        np.testing.assert_allclose(got[2][g].numpy(), np.asarray(want.x_last),
                                   atol=1e-9)
        np.testing.assert_array_equal(got[3][g].numpy(),
                                      np.asarray(want.switch_t))


# -------------------------------------------------- the main path's launches

def _g_per_horizon(T_grid, runs):
    """The parent's loop: one FTRL batch a horizon, its maximum floored at
    0.0."""
    out = {}
    for T in T_grid:
        z, y = sample_g_batch(0, T, runs)
        cum, comp, _ = game.regrets_fused(torch.from_numpy(z),
                                          torch.from_numpy(y), 0, ETA)
        out[T] = max(0.0, float((cum - comp).max()))
    return out


@pytest.mark.parametrize("chunk", [16384, 5])
def test_ragged_g_table_equals_per_horizon_loop(chunk):
    """All horizons' runs in one ragged launch (or in launches that cut
    across horizons) give the per-horizon loop's table in every bit."""
    grid = (30, 60, 90)
    got = estimate_g(grid, runs=7, chunk=chunk, progress=False, device="cpu")
    assert got == _g_per_horizon(grid, 7)


def test_resumed_g_table_computes_only_missing_horizons(tmp_path):
    """The cache records every horizon; a resumed run keeps the cached ones
    and computes the rest in one launch."""
    cache = str(tmp_path / "g.json")
    full = estimate_g((30, 60, 90), runs=6, cache_path=cache, progress=False,
                      device="cpu")
    with open(cache) as f:
        saved = json.load(f)
    assert {k for k in saved if k != "_meta"} == {"30", "60", "90"}
    saved["60"] = 123.0
    del saved["90"]
    with open(cache, "w") as f:
        json.dump(saved, f)
    again = estimate_g((30, 60, 90), runs=6, cache_path=cache,
                       progress=False, device="cpu")
    assert again == {30: full[30], 60: 123.0, 90: full[90]}


@pytest.mark.parametrize("title", ["Random i.i.d. (separable)",
                                   "Massart noise 10%"])
def test_evaluation_geometry_is_bit_for_bit(title):
    """One K1 and one K2 launch a case give the statistics of the parent's
    4,096-sequence chunks and of launches cut across horizons, in every
    bit; the per-scenario regrets equal the parent's doubled calls."""
    g = {40: 4.0, 80: 6.0}
    kw = dict(runs=3, replicates=2, progress=False, device="cpu")
    stats = [pt_evaluate.evaluate_stream_with_stats(
        CASES[title], (40, 80), g, batch_chunk=bc, **kw)
        for bc in (16384, 4096, 5)]
    for other in stats[1:]:
        for k in pt_evaluate.ALGO_KEYS:
            np.testing.assert_array_equal(stats[0][k][0], other[k][0])
            np.testing.assert_array_equal(stats[0][k][1], other[k][1])
    z, y, lengths = _batch(30, 80, seed=3)
    ths = torch.stack([torch.sqrt(2.0 * lengths.double()),
                       torch.full((30,), 3.0, dtype=torch.float64)])
    cum, comp, _ = game.regret_plays(z, y, (0, 1), ETA, lengths, False)
    cum_s, comp_s, _, _ = smart.smart_plays(z, y, ths, ETA, lengths, False)
    z2, y2, l2 = torch.cat([z, z]), torch.cat([y, y]), torch.cat([lengths,
                                                                  lengths])
    c1, k1, _ = game.regrets_fused(z2, y2, torch.tensor([0] * 30 + [1] * 30),
                                   ETA, l2)
    c2, k2, _, _ = smart.smart_regrets(z2, y2, ths.reshape(-1), ETA, l2)
    assert torch.equal((cum - comp).reshape(-1), c1 - k1)
    assert torch.equal((cum_s - comp_s).reshape(-1), c2 - k2)


def test_replay_of_the_plays_scores_each_play():
    """Replay mode scores each play's own final FTL action over the rows:
    each play equals ``regrets_fused_reference`` in replay mode."""
    z, y, lengths = _batch(16, 30, seed=9, contract=False)
    cum, comp, x_last = game.regret_plays(z, y, (0, 1), ETA, lengths, True)
    for p in range(2):
        want = game.regrets_fused_reference(
            z, y, torch.full((16,), p),
            torch.full((16,), ETA, dtype=torch.float64), lengths, replay=True)
        _equal((cum[p], comp[p], x_last[p]), want)
