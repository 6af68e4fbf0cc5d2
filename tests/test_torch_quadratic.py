"""The quadratic-loss track (kernels K8 and K9, their plain versions on the
CPU) against the JAX package.

- ``make_regression_stream`` bit for bit; ``regression_stream_batch`` by
  its distribution;
- ``ball_ls_action`` in float64 against scipy SLSQP and the JAX x64
  bisection on prefixes t in {1, 2, 3, 4, 8, 40} (singular t < d
  included) and the null-space case; in float32 against the JAX Pallas
  kernel in interpret mode, 2e-5 at t >= 8 as tests/test_quadratic.py
  holds it;
- ``simulate_quadratic_batch`` in float64 against JAX x64 with mixed flags,
  in float32 against the JAX fused kernel (interpret mode) and the float64
  truth within the JAX test's own bounds (max 0.05, mean 2e-3);
- the study end to end, and its float64 statistics against the JAX
  package's;
- at d = 40, past the thin kernels' d <= 32 (where the card runs the wide
  instances K9w and K8w, which equal these plain versions bit for bit):
  ``trs_solve_reference`` against the JAX x64 solver and SLSQP on full-rank
  problems (1e-9), and ``quadratic_regrets_reference`` against the JAX
  x64 game's body on the fixture's solves (FTRL 1e-9, FTL cum 1e-4 for
  the singular first rounds);
  K8w's warp map.

Tolerances against JAX x64: 1e-12 wherever the statistics are full rank.
On a singular prefix (t < d) the ridge floor eps = 1e-12 (1 + tr/d) leaves
``A + eps I`` with a condition number near 1e12, so one rounding difference
(the JAX CPU backend and the port round some operations differently) moves
the null-space part of the f64 answer by up to ~1e-5, at an objective equal
to 1e-16.  The FTL losses of a game's first d - 1 rounds inherit that, so
FTL cum and regret are held at 1e-4 on data whose first rows are random,
and at 1e-12 on data whose first d rows are basis vectors (every singular
prefix then exact in floating point).
"""

import numpy as np
import pytest
import torch
from scipy.optimize import minimize

import jax.numpy as jnp

from online_convex_optimization_tpu.data.sequences import (
    make_regression_stream as jax_regression_stream,
)
from online_convex_optimization_tpu.experiments.quadratic_study import (
    evaluate_quadratic_stream as jax_evaluate,
)
from online_convex_optimization_tpu.models.quadratic import (
    ball_ls_action as jax_ball_ls_action,
    simulate_quadratic_batch as jax_quadratic_batch,
)
from online_convex_optimization_tpu.ops.pallas_game import (
    pack_sequences,
    unpack_result,
)
from online_convex_optimization_tpu.ops.pallas_trs import (
    ball_ls_action_pallas,
    quadratic_regrets_packed,
)
from online_convex_optimization_tpu_torch.data.device import (
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.data.sequences import (
    make_regression_stream,
)
from online_convex_optimization_tpu_torch.experiments.quadratic_study import (
    evaluate_quadratic_stream,
    main as study_main,
)
from online_convex_optimization_tpu_torch.models.quadratic import (
    ball_ls_action,
    quadratic_comparator_loss,
    simulate_quadratic,
    simulate_quadratic_batch,
)
from online_convex_optimization_tpu_torch.ops import trs
from online_convex_optimization_tpu_torch.ops.actions import sum_last

torch.set_num_threads(1)

X64_TOL = 1e-12
SINGULAR_TOL = 1e-4


def _instance(T, d=5, seed=0, sigma=0.3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    return z, z @ u + sigma * rng.normal(size=T)


def _obj(z, y, x):
    return 0.5 * float(np.sum((z @ x - y) ** 2))


def _slsqp_quad(A, b, seed=0):
    rng = np.random.default_rng(seed)
    best = np.inf
    for _ in range(8):
        x0 = rng.normal(size=len(b))
        x0 /= max(np.linalg.norm(x0), 1.0) * 1.1
        r = minimize(lambda x: 0.5 * x @ A @ x - b @ x, x0, method="SLSQP",
                     constraints=[{"type": "ineq",
                                   "fun": lambda x: 1.0 - x @ x}],
                     options={"maxiter": 400, "ftol": 1e-14})
        best = min(best, r.fun)
    return best


def _game_batch(B, T, d=5, seed=0, *, basis_first=False):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    if basis_first:
        z[:, :d] = 0.8 * np.eye(d)
    y = z @ (np.ones(d) / np.sqrt(d)) + 0.2 * rng.normal(size=(B, T))
    return z, y


# --------------------------------------------------------------- the data

def test_regression_stream_equals_jax_bit_for_bit():
    for seed, sigma, d in ((7, 0.2, 5), (2025, 0.1, 5), (3, 0.5, 3)):
        for T, rep in ((256, 0), (100, 3)):
            got = make_regression_stream(sigma=sigma, d=d, run_seed=seed)(
                T, rep=rep)
            want = jax_regression_stream(sigma=sigma, d=d, run_seed=seed)(
                T, rep=rep)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_regression_stream_batch_distribution(dtype):
    gen = torch.Generator().manual_seed(4)
    z, y, u = regression_stream_batch(gen, 64, 512, 5, sigma=0.3,
                                      dtype=dtype)
    assert z.shape == (64, 512, 5) and y.shape == (64, 512)
    assert u.shape == (64, 5) and z.dtype == y.dtype == u.dtype == dtype
    assert float(torch.linalg.vector_norm(z, dim=-1).max()) <= 1.0
    torch.testing.assert_close(torch.linalg.vector_norm(u, dim=-1),
                               torch.ones(64, dtype=dtype))
    noise = (y - (z * u[:, None, :]).sum(-1)).double()
    assert abs(float(noise.mean())) < 0.01          # 32,768 draws: sd 0.0017
    assert abs(float(noise.std()) - 0.3) < 0.01
    again = regression_stream_batch(torch.Generator().manual_seed(4), 64, 512,
                                    5, sigma=0.3, dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip((z, y, u), again))


# ------------------------------------------------------- the trust region

@pytest.mark.parametrize("t", [1, 2, 3, 4, 8, 40])
def test_ball_ls_action_x64_matches_jax_and_slsqp(t):
    z, y = _instance(T=40, seed=1)
    A, b = z[:t].T @ z[:t], z[:t].T @ y[:t]
    x = ball_ls_action(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_ball_ls_action(jnp.asarray(A), jnp.asarray(b)))
    assert np.linalg.norm(x) <= 1.0 + 1e-12
    obj = lambda v: 0.5 * v @ A @ v - b @ v
    assert obj(x) <= _slsqp_quad(A, b, seed=t) + 1e-8
    assert abs(obj(x) - obj(want)) <= X64_TOL
    np.testing.assert_allclose(x, want, rtol=0,
                               atol=X64_TOL if t >= 5 else SINGULAR_TOL)


def test_f64_newton_has_converged(monkeypatch):
    """20 Newton iterations in f64 (K8's and K9's count): the answer stops
    moving after 18, on every prefix of the tests' instances and of a
    regression stream, and on random PSD problems."""
    As, bs = [], []
    for seed in range(4):
        z, y = _instance(T=60, seed=seed)
        for t in range(61):
            As.append(z[:t].T @ z[:t])
            bs.append(z[:t].T @ y[:t])
    z, y, _ = make_regression_stream(sigma=0.1, run_seed=3)(300)
    z, y = z.astype(np.float64), y.astype(np.float64)
    for t in range(0, 301, 5):
        As.append(z[:t].T @ z[:t])
        bs.append(z[:t].T @ y[:t])
    rng = np.random.default_rng(9)
    M = rng.normal(size=(200, 5, 5))
    As += list(M @ M.transpose(0, 2, 1) * rng.uniform(0.01, 10, (200, 1, 1)))
    bs += list(rng.normal(size=(200, 5)) * rng.uniform(0.1, 20, (200, 1)))
    A, b = torch.from_numpy(np.array(As)), torch.from_numpy(np.array(bs))
    assert trs.TRS_PARAMS[torch.float64] == (1e-12, 20)
    got = {}
    for iters in (18, 20, 40):
        monkeypatch.setitem(trs.TRS_PARAMS, torch.float64, (1e-12, iters))
        got[iters] = trs.trs_solve(A, b)
    assert torch.equal(got[18], got[20]) and torch.equal(got[20], got[40])


def test_ball_ls_action_null_space_gradient():
    """Singular A with b pulling along its null space: the answer is on the
    boundary along that direction (the lam = 0 pseudo-inverse is wrong)."""
    A = np.zeros((4, 4))
    A[0, 0] = 2.0
    b = np.array([0.5, 1.0, 0.0, 0.0])
    x = ball_ls_action(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.linalg.norm(x) == pytest.approx(1.0, abs=1e-12)
    assert 0.5 * x @ A @ x - b @ x <= _slsqp_quad(A, b) + 1e-8
    want = np.asarray(jax_ball_ls_action(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("t", [1, 3, 8, 40])
def test_trs_f32_matches_jax_pallas_interpret(t):
    z, y = _instance(T=40, seed=5)
    zp, yp = z[:t].astype(np.float32), y[:t].astype(np.float32)
    A, b = (zp.T @ zp)[None], (zp.T @ yp)[None]
    got = trs.trs_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()[0]
    want = np.asarray(ball_ls_action_pallas(jnp.asarray(A), jnp.asarray(b),
                                            interpret=True))[0]
    assert _obj(zp, yp, got) <= _obj(zp, yp, want) + 1e-6
    if t >= 8:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.linalg.norm(got) <= 1.0 + 1e-6


def test_trs_batch_f32_matches_jax_pallas_interpret():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(300, 5, 5)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1)
    b = rng.normal(size=(300, 5)).astype(np.float32)
    got = ball_ls_action(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.asarray(ball_ls_action_pallas(jnp.asarray(A), jnp.asarray(b),
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # (..., d, d) batches keep their shape.
    assert ball_ls_action(torch.from_numpy(A).reshape(3, 100, 5, 5),
                          torch.from_numpy(b).reshape(3, 100, 5)).shape == (
                              3, 100, 5)


def test_correctly_rounded_sqrt():
    rng = np.random.default_rng(0)
    for dtype in (np.float64, np.float32):
        x = np.concatenate([[0.0, 1.0, 2.0, 4.0],
                            rng.random(20_000) * 10.0 ** rng.integers(
                                -30, 30, 20_000)]).astype(dtype)
        got = trs.correctly_rounded_sqrt(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.sqrt(x))


# ---------------------------------------------------------- the K8 game

@pytest.mark.parametrize("basis_first", [True, False])
def test_quadratic_batch_x64_matches_jax(basis_first):
    z, y = _game_batch(16, 60, seed=0, basis_first=basis_first)
    flags = np.arange(16) % 2
    eta = np.linspace(0.5, 2.0, 16)
    got = simulate_quadratic_batch(torch.from_numpy(z), torch.from_numpy(y),
                                   torch.from_numpy(flags),
                                   torch.from_numpy(eta))
    want = jax_quadratic_batch(z, y, flags, eta)
    ftl_tol = X64_TOL if basis_first else SINGULAR_TOL
    for name in ("cum_loss", "regret", "comp_loss", "x_last"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g[flags == 0], w[flags == 0], rtol=0,
                                   atol=X64_TOL)
        np.testing.assert_allclose(
            g[flags == 1], w[flags == 1], rtol=0,
            atol=ftl_tol if name in ("cum_loss", "regret") else X64_TOL)


def test_quadratic_plain_equals_per_round_solves():
    """The plain version's all-prefix solve is K8's per-round order: the
    same cum, comparator and actions as solving each prefix in turn."""
    z, y = _game_batch(6, 20, d=4, seed=8)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    z_tm, y_tm = zt.permute(1, 2, 0), yt.t()
    cum, comp, x_c, x_last = trs.quadratic_regrets(z_tm, y_tm, 1)
    A = torch.zeros((6, 4, 4), dtype=torch.float64)
    b = torch.zeros((6, 4), dtype=torch.float64)
    want = torch.zeros(6, dtype=torch.float64)
    for t in range(20):
        x = trs.trs_solve(A, b)
        r = sum_last(zt[:, t] * x) - yt[:, t]
        want = want + 0.5 * r * r
        A = A + zt[:, t, :, None] * zt[:, t, None, :]
        b = b + yt[:, t, None] * zt[:, t]
    assert torch.equal(cum, want)
    assert torch.equal(x_last.t(), x)
    assert torch.equal(x_c.t(), trs.trs_solve(A, b))
    c = (yt * yt).sum(-1)
    torch.testing.assert_close(comp, quadratic_comparator_loss(A, b, c,
                                                               x_c.t()),
                               rtol=0, atol=1e-12)


def test_quadratic_first_rounds():
    """t = 0: A = b = 0 and the action is 0; one round loses 0.5 y^2."""
    z, y = _game_batch(4, 1, seed=2)
    res = simulate_quadratic_batch(torch.from_numpy(z), torch.from_numpy(y),
                                   1, 1.0)
    assert torch.equal(res.x_last, torch.zeros((4, 5), dtype=torch.float64))
    assert torch.equal(res.cum_loss, torch.from_numpy(0.5 * y[:, 0] ** 2))


def test_quadratic_f32_matches_jax_fused_kernel_and_f64_truth():
    """float32 within the JAX test's own bounds of the f64 truth (max 0.05,
    mean 2e-3: f32 trajectory noise on ill-conditioned early prefixes), and
    of the JAX fused kernel in interpret mode."""
    rng = np.random.default_rng(0)
    B, T, d = 64, 48, 5
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = (z @ (np.ones(d) / np.sqrt(d))
         + 0.2 * rng.normal(size=(B, T))).astype(np.float32)
    got = simulate_quadratic_batch(torch.from_numpy(z), torch.from_numpy(y),
                                   1, 1.0).regret.numpy()
    truth = simulate_quadratic_batch(
        torch.from_numpy(z.astype(np.float64)),
        torch.from_numpy(y.astype(np.float64)), 1, 1.0).regret.numpy()
    zp, yp, _ = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    kern = np.asarray(unpack_result(
        quadratic_regrets_packed(zp, yp, interpret=True), B))
    for want in (truth, kern):
        assert np.abs(got - want).max() < 0.05
        assert abs(got.mean() - want.mean()) < 2e-3


def test_simulate_quadratic_single_sequence():
    z, y = _instance(T=80, seed=3, sigma=0.05)
    ftl = simulate_quadratic(z, y, alg="ftl", device="cpu")
    batch = simulate_quadratic_batch(torch.from_numpy(z[None]),
                                     torch.from_numpy(y[None]), 1, 1.0)
    assert ftl.regret == float(batch.regret[0])
    ftrl = simulate_quadratic(z, y, alg="ftrl", eta0=1.0, device="cpu")
    assert ftl.cum_loss < ftrl.cum_loss and ftl.regret >= -1e-6
    with pytest.raises(ValueError):
        simulate_quadratic(z, y, alg="smart", device="cpu")


def test_quadratic_kernel_d_limit_and_inputs():
    """Every d has a kernel instance: the thin ones up to MAX_D = 32, the
    wide ones (K9w, K8w) above; the shape and dtype refusals stay."""
    from online_convex_optimization_tpu_torch.ops.game import (
        check_time_major)
    assert trs.MAX_D == 32 and not trs.wide_instance(32)
    for d in (33, 64):
        assert trs.wide_instance(d)
        z = torch.zeros((4, d, 2), dtype=torch.float64)
        y = torch.zeros((4, 2), dtype=torch.float64)
        assert check_time_major(z, y) == (4, d, 2)
        assert trs.check_trs(torch.zeros((2, d, d)), torch.zeros((2, d))) \
            == (2, d)
        # K8w plays a sequence a warp: a width of the thin map is refused.
        flags = torch.ones(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="width"):
            trs.launch_quadratic_regrets(z, y, flags, flags.double(), 4)
    with pytest.raises(ValueError):
        trs.trs_solve(torch.zeros((2, 4, 4)), torch.zeros((2, 5)))
    with pytest.raises(TypeError):
        trs.trs_solve(torch.zeros((2, 4, 4)), torch.zeros((2, 4),
                                                          dtype=torch.float64))


# ------------------------------------------------------------ the study

def test_quadratic_study_x64_stats_match_jax():
    kw = dict(runs=2, replicates=2, dtype=np.float64)
    got = evaluate_quadratic_stream((100, 200, 300), device="cpu", **kw)
    want = jax_evaluate((100, 200, 300), **kw)
    assert got.keys() == want.keys()
    for k in got:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(
                g, w, rtol=0,
                atol=SINGULAR_TOL if k.startswith("FTL") else X64_TOL)


def test_quadratic_study_end_to_end(tmp_path):
    import json
    import os

    results = study_main(["--t-min", "100", "--t-max", "300", "--t-step", "100",
                    "--runs", "2", "--replicates", "2", "--dpi", "60",
                    "--out-dir", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "results_quadratic.json") as f:
        assert json.load(f)["stats"] == results["stats"]
    assert results["device"] == {"type": "cpu"}
    if results["figure"] is not None:
        assert os.path.exists(results["figure"])
    ftl = results["stats"]["FTL (exact LS)"]["mean"]
    ftrl = results["stats"]["FTRL"]["mean"]
    assert all(np.isfinite(ftl)) and all(np.isfinite(ftrl))
    assert ftl[-1] < ftrl[-1]


# ------------------------------------------ d = 40: the wide instances' d

WIDE_D = 40


def _prefix_statistics(z, y):
    """The running (A, b) before every round, ``(B, T, d, d)`` and
    ``(B, T, d)``, and the final ones, summed in round order."""
    A = np.cumsum(z[:, :, :, None] * z[:, :, None, :], axis=1)
    b = np.cumsum(y[:, :, None] * z, axis=1)
    A_pre = np.concatenate([np.zeros_like(A[:, :1]), A[:, :-1]], axis=1)
    b_pre = np.concatenate([np.zeros_like(b[:, :1]), b[:, :-1]], axis=1)
    return A_pre, b_pre, A[:, -1], b[:, -1]


@pytest.fixture(scope="module")
def wide_jax():
    """The JAX x64 solver (``ball_ls_action``) at d = 40, in one call:
    on four full-rank problems (t = 60 and 120 rows, b scaled to reach the
    interior and the boundary) and on the game's prefix and final
    statistics.  The JAX game (``simulate_quadratic_batch``) plays exact
    FTL with this function on the same statistics; it unrolls its
    Cholesky (d^3 / 3 traced operations, ~15 s to trace and ~18 s to
    compile at d = 40), and the game traces it twice, so the test calls it
    once for everything."""
    z, y = _instance(T=120, d=WIDE_D, seed=5)
    probs = [(z[:t].T @ z[:t], scale * (z[:t].T @ y[:t]))
             for t, scale in ((60, 1.0), (120, 1.0), (120, 0.05),
                              (120, 20.0))]
    zg, yg = _game_batch(4, 48, d=WIDE_D, seed=3)
    A_pre, b_pre, A_fin, b_fin = _prefix_statistics(zg, yg)
    B, T = yg.shape
    A_all = np.concatenate([np.stack([a for a, _ in probs]),
                            A_pre.reshape(-1, WIDE_D, WIDE_D), A_fin])
    b_all = np.concatenate([np.stack([b for _, b in probs]),
                            b_pre.reshape(-1, WIDE_D), b_fin])
    x = np.asarray(jax_ball_ls_action(jnp.asarray(A_all), jnp.asarray(b_all)))
    return {"probs": probs, "x_probs": x[:4],
            "game": (zg, yg, A_fin, b_fin),
            "x_pre": x[4:4 + B * T].reshape(B, T, WIDE_D),
            "x_fin": x[4 + B * T:]}


def test_trs_reference_wide_matches_jax_x64_and_slsqp(wide_jax):
    A = np.stack([a for a, _ in wide_jax["probs"]])
    b = np.stack([v for _, v in wide_jax["probs"]])
    x = trs.trs_solve_reference(torch.from_numpy(A),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, wide_jax["x_probs"], rtol=0, atol=1e-9)
    norms = np.linalg.norm(x, axis=1)
    assert (norms <= 1.0 + 1e-12).all()
    assert (norms < 0.5).any() and (np.abs(norms - 1.0) < 1e-12).any()
    for Ai, bi, xi in zip(A, b, x):
        obj = lambda v: 0.5 * v @ Ai @ v - bi @ v
        r = minimize(obj, np.zeros(WIDE_D), jac=lambda v: Ai @ v - bi,
                     method="SLSQP",
                     constraints=[{"type": "ineq", "fun": lambda v: 1.0 - v @ v,
                                   "jac": lambda v: -2.0 * v}],
                     options={"maxiter": 1000, "ftol": 1e-15})
        xs = r.x / max(1.0, np.linalg.norm(r.x))     # feasible
        assert obj(xi) <= obj(xs) + 1e-9 * max(1.0, abs(obj(xs)))


def test_quadratic_reference_wide_matches_jax_x64(wide_jax, monkeypatch):
    """The plain K8 at d = 40 (B = 4, T = 48, f64, FTRL and FTL) against
    the JAX x64 game's own body (``_simulate_quadratic_batch``, run once,
    unjitted): its FTRL scan, cum, comparator and last actions.  Its
    trust-region solver is the fixture's call of the JAX solver on the
    same statistics (checked against the ones the game forms), so that
    the game does not trace its unrolled Cholesky twice more."""
    from online_convex_optimization_tpu.models import quadratic as jq
    zg, yg, A_fin, b_fin = wide_jax["game"]
    B, T, d = zg.shape
    A_pre = np.concatenate([np.zeros((B, 1, d, d)),
                            np.cumsum(zg[:, :, :, None] * zg[:, :, None, :],
                                      axis=1)[:, :-1]], axis=1)
    solved = {4: (A_pre, wide_jax["x_pre"]), 3: (A_fin, wide_jax["x_fin"])}

    def solver(A, b):
        A_want, x = solved[A.ndim]
        np.testing.assert_allclose(np.asarray(A), A_want, rtol=1e-12,
                                   atol=1e-12)
        return jnp.asarray(x)

    monkeypatch.setattr(jq, "ball_ls_action", solver)
    flags = np.arange(B) % 2
    eta = np.linspace(0.5, 2.0, B)
    want = [np.asarray(a) for a in jq._simulate_quadratic_batch.__wrapped__(
        jnp.asarray(zg), jnp.asarray(yg), jnp.asarray(flags),
        jnp.asarray(eta))]
    cum, comp, x_c, x_last = trs.quadratic_regrets_reference(
        torch.from_numpy(zg).permute(1, 2, 0), torch.from_numpy(yg).t(),
        torch.from_numpy(flags), torch.from_numpy(eta))
    ftl, ftrl = flags == 1, flags == 0
    np.testing.assert_allclose(cum.numpy()[ftrl], want[0][ftrl], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(cum.numpy()[ftl], want[0][ftl], rtol=0,
                               atol=SINGULAR_TOL)
    np.testing.assert_allclose(comp.numpy(), want[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(x_c.t().numpy(), want[2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(x_last.t().numpy(), want[3], rtol=0,
                               atol=1e-9)


def test_wide_warp_map():
    """K8w's warp map: every sequence once, the FTL sequences first, each
    flag's in order (one sequence a warp, so FTRL and FTL share a launch);
    the thin map's width does not apply there."""
    flags = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1, 1], dtype=torch.int32)
    order = trs.quad_warps(flags)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 2, 4, 7, 8, 0, 3, 5, 6]
    assert trs.quad_warps(torch.zeros(5, dtype=torch.int32)).tolist() == \
        list(range(5))
    assert trs.quad_warps(torch.ones(3, dtype=torch.int32)).tolist() == \
        [0, 1, 2]


def _chol_factor_loop(A, lam, d):
    """The entry-by-entry factorization the plain version's column-at-once
    loop replaced: (i, j) subtracts L_ik L_jk for k < j in turn."""
    L = [None] * len(A)
    for i in range(d):
        for j in range(i + 1):
            s = A[trs._tri(i, j)] + lam if i == j else A[trs._tri(i, j)]
            for k in range(j):
                s = s - L[trs._tri(i, k)] * L[trs._tri(j, k)]
            L[trs._tri(i, j)] = (trs.correctly_rounded_sqrt(s) if i == j
                                 else s / L[trs._tri(j, j)])
    return L


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 5, 12, 33])
def test_column_factor_equals_the_entry_loop(dtype, d):
    """The plain Cholesky and forward solve, a column of subtractions at a
    time, equal the entry-by-entry loops in every bit (the kernels' order
    of operations), singular statistics included."""
    z, y, _ = regression_stream_batch(torch.Generator().manual_seed(d), 2,
                                      d + 3, d, dtype=dtype)
    rows, cols = trs.tri_index(d)
    A = torch.cumsum(z[:, :, :, None] * z[:, :, None, :], 1)
    b = torch.cumsum(y[:, :, None] * z, 1)
    A = [A[..., i, j] for i, j in zip(rows, cols)]
    b = [b[..., i] for i in range(d)]
    lam = trs._trs_setup(A, b)[0]
    L = trs._chol_factor(A, lam, d)
    want = _chol_factor_loop(A, lam, d)
    assert all(torch.equal(L[k], w) for k, w in enumerate(want))
    v = trs._fwd_solve(L, b, d)
    for i in range(d):
        s = b[i]
        for k in range(i):
            s = s - want[trs._tri(i, k)] * v[k]
        assert torch.equal(v[i], s / want[trs._tri(i, i)])

