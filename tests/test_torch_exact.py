"""The port's exact-FTL track against the JAX package and independent
solvers, on the CPU.

Bars and why:
  - the NumPy copies (polish, linear_regime, canonical): bit for bit on the
    same inputs (the same code);
  - the banded, full and masked ADMM formulations in f64 at fixed
    iterations: within 1e-12 of JAX x64 (only matmul reduction orders
    differ, ~1e-16 a product);
  - ``ExactFTL`` against scipy HiGHS (linf, l1) and SLSQP (l2): objectives
    within 1e-8, the reference's interior-point bar
    (``tests/test_exact_ftl.py``);
  - ``evaluate_stream_exact`` on ``CASES`` at T in (30, 50), 2 runs x 2
    replicates: route ``auto`` within 1e-9 of JAX (certified and canonical
    cells are the same host f64 NumPy); ``xla`` (selection ``committed``)
    within 1e-8: its ADMM iterates agree with JAX's to ~1e-15, but where a
    prefix's optimal face is degenerate the polish's pseudo-inverse moves
    the selected point by up to ~1e-8 at equal objective (measured: stats
    2.2e-9 apart on "Massart noise 10%", T = 50; the polished objectives
    agree to 1e-12, held below); ``kernel`` (f32) within 1e-5, as the JAX
    package holds its kernel route against its XLA route; the audit dicts
    equal;
  - ``estimate_g_exact`` (``auto`` and ``xla``): within 1e-9 (the
    comparator losses are objectives, which do not depend on the selected
    point).
"""

import json
import math

import numpy as np
import pytest
import torch
from scipy.optimize import linprog, minimize

import jax.numpy as jnp

from online_convex_optimization_tpu.data.sequences import CASES as JAX_CASES
from online_convex_optimization_tpu.experiments import evaluate as jax_evaluate
from online_convex_optimization_tpu.experiments import gt as jax_gt
from online_convex_optimization_tpu.models import canonical as jax_canonical
from online_convex_optimization_tpu.models import exact_ftl as jax_exact
from online_convex_optimization_tpu.models import linear_regime as jax_regime
from online_convex_optimization_tpu.models import polish as jax_polish
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.experiments import driver as pt_driver
from online_convex_optimization_tpu_torch.experiments import evaluate as pt_evaluate
from online_convex_optimization_tpu_torch.experiments import gt as pt_gt
from online_convex_optimization_tpu_torch.experiments.config import (
    ExperimentConfig,
    config_from_args,
)
from online_convex_optimization_tpu_torch.models import canonical, exact_ftl
from online_convex_optimization_tpu_torch.models import linear_regime, polish
from online_convex_optimization_tpu_torch.models.exact_ftl import (
    ExactFTL,
    replay_exact_ftl,
    run_ftl_exact,
    run_ftrl,
    simulate,
)

torch.set_num_threads(1)

NORMS = ["l2", "linf", "l1"]


def _instance(T=60, d=5, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    y = np.sign(z @ u + noise * rng.normal(size=T))
    return z, y


def _obj(z, y, x):
    return 0.5 * np.sum(np.abs(z @ x - y))


def _lp_solve(z, y, norm):
    """Exact LP solution for the linf (box) and l1 (cross-polytope) balls."""
    T, d = z.shape
    if norm == "linf":
        c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
        A_ub = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
        b_ub = np.concatenate([y, -y])
        bounds = [(-1, 1)] * d + [(0, None)] * T
        res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
        return res.x[:d]
    c = np.concatenate([np.zeros(2 * d), 0.5 * np.ones(T)])
    A_res = np.block([[z, -z, -np.eye(T)], [-z, z, -np.eye(T)]])
    A_l1 = np.concatenate([np.ones(2 * d), np.zeros(T)])[None, :]
    res = linprog(c, A_ub=np.vstack([A_res, A_l1]),
                  b_ub=np.concatenate([y, -y, [1.0]]),
                  bounds=[(0, None)] * (2 * d + T), method="highs")
    return res.x[:d] - res.x[d:2 * d]


def _solver(**kw):
    kw.setdefault("device", "cpu")
    return ExactFTL(**kw)


# ------------------------------------------------------- the NumPy copies

@pytest.mark.parametrize("norm", NORMS)
def test_polish_copy_is_the_jax_packages(norm):
    z, y = _instance(T=40, seed=21)
    rng = np.random.default_rng(1)
    acts = np.concatenate([np.zeros((1, 5)),
                           0.4 * rng.normal(size=(40, 5))])
    np.testing.assert_array_equal(
        polish.polish_prefix_actions(z, y, acts, norm),
        jax_polish.polish_prefix_actions(z, y, acts, norm))
    np.testing.assert_array_equal(
        polish.polish_solution(z, y, acts[-1], norm),
        jax_polish.polish_solution(z, y, acts[-1], norm))


@pytest.mark.parametrize("norm", NORMS)
def test_linear_regime_copy_is_the_jax_packages(norm):
    rng = np.random.default_rng(2)
    z = rng.normal(size=(3, 50, 5))
    z *= (0.3 if norm != "l2" else 1.0) / np.maximum(
        np.linalg.norm(z, axis=-1, keepdims=True), 1.0)
    y = np.where(rng.random((3, 50)) < 0.5, -1.0, 1.0)
    got = linear_regime.certified_prefix_actions_batch(z, y, norm)
    want = jax_regime.certified_prefix_actions_batch(z, y, norm)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    for a, b in zip(linear_regime.certified_full_solution_batch(z, y, norm),
                    jax_regime.certified_full_solution_batch(z, y, norm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("norm", NORMS)
def test_canonical_copy_is_the_jax_packages(norm):
    z, y = CASES["Switching leaders"](run_seed=2025)(60, rep=0)[:2]
    np.testing.assert_array_equal(
        canonical.canonical_prefix_actions(z, y, norm),
        jax_canonical.canonical_prefix_actions(z, y, norm))
    zi, yi = _instance(T=30, seed=4)
    x = 0.2 * np.ones(5)
    np.testing.assert_array_equal(canonical.canonicalize(zi, yi, x, norm),
                                  jax_canonical.canonicalize(zi, yi, x, norm))


# ------------------------------------------ the XLA formulations, in f64

@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("band", [False, True])
def test_all_prefixes_matches_jax_x64(norm, band):
    z, y = _instance(T=40, seed=15)
    kw = dict(norm=norm, iters=300, tol=0.0)
    if band:
        kw.update(band_lo=25, band_rows=15)
    Xj, rj, _ = jax_exact._admm_all_prefixes(jnp.asarray(z), jnp.asarray(y),
                                             **kw)
    Xp, rp, _ = exact_ftl._admm_all_prefixes(torch.from_numpy(z),
                                             torch.from_numpy(y), **kw)
    np.testing.assert_allclose(Xp.numpy(), np.asarray(Xj), atol=1e-12, rtol=0)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=1e-12, rtol=0)


@pytest.mark.parametrize("norm", NORMS)
def test_full_and_masked_solves_match_jax_x64(norm):
    z, y = _instance(T=30, seed=16)
    xj, rj, _ = jax_exact._admm_full(jnp.asarray(z), jnp.asarray(y),
                                     norm=norm, iters=400)
    xp, rp, _ = exact_ftl._admm_full(torch.from_numpy(z), torch.from_numpy(y),
                                     norm=norm, iters=400)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-12, rtol=0)
    assert abs(float(rp) - float(rj)) <= 1e-12
    m = (np.arange(30) < 17).astype(np.float64)
    zero = [np.zeros(5), np.zeros(30), np.zeros(30), np.zeros(5), np.zeros(5)]
    stj, rj = jax_exact._admm_masked_warm(
        jnp.asarray(z), jnp.asarray(y), jnp.asarray(m),
        tuple(jnp.asarray(a) for a in zero), norm=norm, iters=200)
    stp, rp = exact_ftl._admm_masked_warm(
        torch.from_numpy(z), torch.from_numpy(y), torch.from_numpy(m),
        tuple(torch.from_numpy(a) for a in zero), norm=norm, iters=200)
    for a, b in zip(stp, stj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12,
                                   rtol=0)


def test_tol_exit_and_continuation_match_jax_and_a_longer_run():
    z, y = _instance(T=40, seed=12)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    Xj, rj, _ = jax_exact._admm_all_prefixes(jnp.asarray(z), jnp.asarray(y),
                                             iters=3000, tol=2e-4)
    Xp, rp, _ = exact_ftl._admm_all_prefixes(zt, yt, iters=3000, tol=2e-4)
    np.testing.assert_allclose(Xp.numpy(), np.asarray(Xj), atol=1e-12, rtol=0)
    _, _, st = exact_ftl._admm_all_prefixes(zt, yt, iters=100)
    Xc, rc, _ = exact_ftl._admm_all_prefixes(zt, yt, iters=150, state0=st)
    Xl, rl, _ = exact_ftl._admm_all_prefixes(zt, yt, iters=250)
    assert torch.equal(Xc, Xl) and torch.equal(rc, rl)
    _, _, st1 = exact_ftl._admm_full(zt, yt, norm="linf", iters=80)
    xc, _, _ = exact_ftl._admm_full(zt, yt, norm="linf", iters=120,
                                    state0=st1)
    xl, _, _ = exact_ftl._admm_full(zt, yt, norm="linf", iters=200)
    assert torch.equal(xc, xl)


def test_batched_members_stop_on_their_own():
    """A batch member stops at its own convergence, as under JAX's vmap of
    the while_loop: each member equals its unbatched solve (bit for bit for
    the prefixes; the full solve's batched matrix-vector products take
    another BLAS routine, so there to 1e-12)."""
    zs, ys = zip(*(_instance(T=30, seed=s) for s in (30, 31, 32)))
    zb, yb = torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(ys))
    Xb, rb, _ = exact_ftl._admm_all_prefixes(zb, yb, iters=3000, tol=2e-4,
                                             band_lo=10, band_rows=20)
    xb, _, _ = exact_ftl._admm_full(zb, yb, iters=3000, tol=2e-4)
    for i in range(3):
        X1, r1, _ = exact_ftl._admm_all_prefixes(zb[i], yb[i], iters=3000,
                                                 tol=2e-4, band_lo=10,
                                                 band_rows=20)
        x1, _, _ = exact_ftl._admm_full(zb[i], yb[i], iters=3000, tol=2e-4)
        assert torch.equal(Xb[i], X1) and torch.equal(rb[i], r1)
        torch.testing.assert_close(xb[i], x1, rtol=0, atol=1e-12)


# ---------------------------------------------- ExactFTL vs LP and NLP

@pytest.mark.parametrize("norm", ["linf", "l1"])
def test_full_solve_matches_highs_lp(norm):
    z, y = _instance()
    x = _solver(d=5, T_max=60, norm=norm, iters=8000, rho=3.0,
                allow_linear=False).solve_full(z, y)
    assert _obj(z, y, x) <= _obj(z, y, _lp_solve(z, y, norm)) + 1e-8


def test_full_solve_matches_slsqp_l2():
    z, y = _instance(seed=1)
    x = _solver(d=5, T_max=60, norm="l2", iters=3000,
                allow_linear=False).solve_full(z, y)
    best = None
    rng = np.random.default_rng(2)
    for _ in range(4):
        r = minimize(lambda v: _obj(z, y, v), 0.1 * rng.normal(size=5),
                     constraints=[{"type": "ineq",
                                   "fun": lambda v: 1 - np.dot(v, v)}],
                     method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
        if best is None or r.fun < best.fun:
            best = r
    assert _obj(z, y, x) <= best.fun + 1e-8
    assert np.linalg.norm(x) <= 1.0 + 1e-9


@pytest.mark.parametrize("norm", ["linf", "l1"])
def test_all_prefixes_match_highs_lp(norm):
    z, y = _instance(T=40, seed=8)
    actions = _solver(d=5, T_max=40, norm=norm, iters=6000, rho=3.0,
                      allow_linear=False).prefix_actions(z, y)
    for p in range(5, 41, 5):
        obj_lp = _obj(z[:p], y[:p], _lp_solve(z[:p], y[:p], norm))
        assert _obj(z[:p], y[:p], actions[p]) <= obj_lp + 1e-8, p


def test_prefix_actions_match_jax_objectives_and_full_solve():
    z, y = _instance(T=40, seed=3)
    solver = _solver(d=5, T_max=40, norm="l2", iters=3000, allow_linear=False)
    actions = solver.prefix_actions(z, y)
    want = jax_exact.ExactFTL(d=5, T_max=40, norm="l2", iters=3000,
                              allow_linear=False).prefix_actions(z, y)
    assert actions.shape == (41, 5)
    np.testing.assert_array_equal(actions[0], 0.0)
    for p in range(1, 41):
        assert abs(_obj(z[:p], y[:p], actions[p])
                   - _obj(z[:p], y[:p], want[p])) <= 1e-12, p
    x_full = solver.solve_full(z, y)
    assert _obj(z, y, actions[-1]) == pytest.approx(_obj(z, y, x_full),
                                                    abs=1e-8)


def test_incremental_surface_and_warm_append_row():
    z, y = _instance(T=20, seed=7)
    solver = _solver(d=5, T_max=20, norm="l2", iters=2000, warm_iters=80,
                     allow_linear=False)
    actions = solver.prefix_actions(z, y)
    solver.reset_buffers()
    for t in range(8):
        x_inc = solver.append_row(z[t], float(y[t]))
        assert solver.last_info["iters"] == (2000 if t == 0 else 80)
        assert _obj(z[:t + 1], y[:t + 1], x_inc) <= \
            _obj(z[:t + 1], y[:t + 1], actions[t + 1]) + 1e-8
    x_pref = solver.solve_prefix(z[:10], y[:10])
    np.testing.assert_allclose(x_pref, solver.solve_prefix_from_full(z, y, 10),
                               atol=1e-9)
    np.testing.assert_array_equal(solver.solve_prefix_from_full(z, y, 0), 0.0)
    with pytest.raises(ValueError):
        solver.solve_prefix(z[:5, :3], y[:5])


def test_append_row_after_certified_streak_takes_the_full_budget():
    rng = np.random.default_rng(21)
    T, d = 12, 5
    z = rng.normal(size=(T, d))
    z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0) * 1.001
    y = np.sign(rng.normal(size=T))
    y[y == 0] = 1.0
    z[-1] *= 8.0
    solver = _solver(d=d, T_max=T, norm="l2", iters=2000, warm_iters=80)
    for t in range(T - 1):
        solver.append_row(z[t], float(y[t]))
        assert solver.last_info.get("solver") == "certified-linear", t
    x_last = solver.append_row(z[-1], float(y[-1]))
    assert solver.last_info["iters"] == 2000 and solver.last_info["converged"]
    x_cold = _solver(d=d, T_max=T, norm="l2", iters=4000,
                     allow_linear=False).solve_full(z, y)
    assert _obj(z, y, x_last) <= _obj(z, y, x_cold) + 1e-7


def test_unconverged_solve_raises_or_sentinels():
    z, y = _instance(T=40, seed=10)
    starved = _solver(d=5, T_max=40, norm="l2", iters=2, fail_tol=1e-6,
                      allow_linear=False)
    with pytest.raises(RuntimeError, match="failed to converge"):
        starved.solve_full(z, y)
    with pytest.raises(RuntimeError, match="failed to converge"):
        starved.prefix_actions(z, y)
    sentinel = _solver(d=5, T_max=40, norm="l2", iters=2, fail_tol=1e-6,
                       on_fail="sentinel", allow_linear=False)
    assert np.isnan(sentinel.solve_full(z, y)).all()
    assert not sentinel.last_info["converged"]
    acts = sentinel.prefix_actions(z, y)
    assert np.isnan(acts[1:]).any() and sentinel.last_info["n_unconverged"] > 0
    ok = _solver(d=5, T_max=40, norm="l2", iters=3000, allow_linear=False)
    ok.solve_full(z, y)
    assert ok.last_info["converged"] and ok.last_info["residual"] < 1e-3


def test_bad_shapes_ssn_and_high_precision_raise():
    z, y = _instance(T=20, seed=6)
    with pytest.raises(ValueError):
        _solver(d=5, T_max=10).prefix_actions(z, y)
    with pytest.raises(ValueError):
        _solver(d=3, T_max=20).prefix_actions(z, y)
    with pytest.raises(ValueError, match="unknown method"):
        _solver(d=5, T_max=20, method="newton")
    # The semismooth Newton is ported (l2 and linf); the l1 ball stays
    # ADMM-only, as in the JAX package.
    with pytest.raises(ValueError, match="l2"):
        _solver(d=5, T_max=20, method="ssn", norm="l1")
    acts = _solver(d=5, T_max=20, method="ssn",
                   allow_linear=False).prefix_actions(3.0 * z, y)
    assert acts.shape == (21, 5) and np.isfinite(acts).all()
    with pytest.raises(ValueError, match="IEEE"):
        _solver(d=5, T_max=20, iter_precision="high")
    with pytest.raises(ValueError, match="IEEE"):
        exact_ftl._admm_full(torch.from_numpy(z), torch.from_numpy(y),
                             precision="high")


def test_banded_prefix_actions_T512():
    z, y = _instance(T=520, seed=16)
    solver = _solver(d=5, T_max=520, norm="l2", iters=1500,
                     allow_linear=False)
    actions = solver.prefix_actions(z, y)
    assert actions.shape == (521, 5)
    x_full = solver.solve_full(z, y)
    assert _obj(z, y, actions[-1]) == pytest.approx(_obj(z, y, x_full),
                                                    abs=1e-8)
    for p in (1, 200, 256, 257, 400, 520):
        assert np.linalg.norm(actions[p]) <= 1.0 + 1e-6
        assert _obj(z[:p], y[:p], actions[p]) <= \
            _obj(z[:p], y[:p], x_full) + 1e-8


def test_front_ends_match_jax():
    z, y = _instance(T=30, seed=4)
    res, actions = run_ftl_exact(z, y, iters=1500, return_actions=True,
                                 device="cpu")
    want, want_actions = jax_exact.run_ftl_exact(z, y, iters=1500,
                                                 return_actions=True)
    assert res.cum_loss == pytest.approx(want.cum_loss, abs=1e-9)
    assert res.regret == pytest.approx(want.regret, abs=1e-9)
    again = replay_exact_ftl(z, y, actions, device="cpu")
    assert again.cum_loss == pytest.approx(res.cum_loss, abs=1e-12)
    ftrl = run_ftrl(z, y, eta0=math.sqrt(2), comparator_action=actions[-1],
                    device="cpu")
    ftrl_j = jax_exact.run_ftrl(z, y, eta0=math.sqrt(2),
                                comparator_action=want_actions[-1])
    assert ftrl.comp_loss == pytest.approx(res.comp_loss, abs=1e-9)
    assert ftrl.regret == pytest.approx(ftrl_j.regret, abs=1e-9)
    r1 = simulate(z, y, algo="ftl_exact", device="cpu")
    r2 = simulate(z, y, algo="ftrl", eta0=1.0, device="cpu")
    assert np.isfinite(r1.regret) and np.isfinite(r2.regret)
    with pytest.raises(ValueError):
        simulate(z, y, algo="nope", device="cpu")
    with pytest.raises(ValueError, match=r"\(T\+1, d\)"):
        replay_exact_ftl(z, y, actions[:-1], device="cpu")


# --------------------------------------------------- the exact pipeline

ROUTES = [("auto", np.float64, "canonical", 1e-9),
          ("xla", np.float64, "committed", 1e-8),
          ("kernel", np.float32, "committed", 1e-5)]


@pytest.mark.parametrize("title", list(CASES))
@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_evaluate_stream_exact_matches_jax(title, route):
    solver, dtype, selection, tol = route
    kw = dict(T_grid=[30, 50], runs=2, replicates=2, iters=1200, dtype=dtype,
              stream_name=title, progress=False, solver=solver,
              selection=selection)
    audit_pt, audit_jax = {}, {}
    got = pt_evaluate.evaluate_stream_exact(CASES[title], audit_out=audit_pt,
                                            device="cpu", **kw)
    want = jax_evaluate.evaluate_stream_exact(JAX_CASES[title],
                                              audit_out=audit_jax, **kw)
    assert audit_pt == audit_jax
    assert audit_pt["cells"] == 4
    for key in want:
        np.testing.assert_allclose(got[key][0], want[key][0], atol=tol, rtol=0)
        np.testing.assert_allclose(got[key][1], want[key][1], atol=tol, rtol=0)


def test_kernel_route_solves_each_horizon_at_its_length(monkeypatch):
    """The kernel route hands K10 (its plain version here) each horizon's
    own rows, not the rows padded to T_max, and stays within the JAX
    kernel route's bar (1e-5) with the same audit."""
    from online_convex_optimization_tpu_torch.ops import admm as pt_admm
    shapes = []
    solve = pt_admm.admm_all_prefixes_l2

    def spy(z, y, **kw):
        shapes.append(tuple(z.shape))
        return solve(z, y, **kw)

    monkeypatch.setattr(pt_admm, "admm_all_prefixes_l2", spy)
    title = "Massart noise 10%"
    kw = dict(T_grid=[20, 45], runs=1, replicates=3, iters=1200,
              dtype=np.float32, stream_name=title, progress=False,
              solver="kernel")
    audit_pt, audit_jax = {}, {}
    got = pt_evaluate.evaluate_stream_exact(CASES[title], audit_out=audit_pt,
                                            device="cpu", **kw)
    want = jax_evaluate.evaluate_stream_exact(JAX_CASES[title],
                                              audit_out=audit_jax, **kw)
    assert audit_pt == audit_jax and audit_pt["cells_kernel"] == 2
    assert shapes[:2] == [(3, 20, 5), (3, 45, 5)]
    assert {s[1] for s in shapes} == {20, 45}
    for key in want:
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_xla_route_polished_objectives_match_jax():
    """Where the xla route's statistics move at 1e-9 (degenerate faces),
    the polished objective of every prefix agrees to 1e-12."""
    sampler = CASES["Massart noise 10%"](run_seed=2025 * 1)
    z, y = sampler(50, rep=0)[:2]
    z, y = z.astype(np.float64), y.astype(np.float64)
    want = jax_exact.ExactFTL(d=5, T_max=50, iters=3600, stop_tol=2e-4,
                              allow_linear=False).prefix_actions(z, y)
    got = _solver(d=5, T_max=50, iters=3600, stop_tol=2e-4,
                  allow_linear=False).prefix_actions(z, y)
    for p in range(1, 51):
        assert abs(_obj(z[:p], y[:p], got[p])
                   - _obj(z[:p], y[:p], want[p])) <= 1e-12, p


def test_evaluate_stream_exact_refusals():
    family = CASES["Random i.i.d. (separable)"]
    kw = dict(T_grid=[20], progress=False, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        pt_evaluate.evaluate_stream_exact(family, solver="kernel",
                                          dtype=np.float64, **kw)
    with pytest.raises(ValueError, match="float32"):
        pt_evaluate.evaluate_stream_exact(family, solver="kernel",
                                          norm="linf", dtype=np.float32, **kw)
    with pytest.raises(ValueError, match="l2"):
        pt_evaluate.evaluate_stream_exact(family, solver="ssn", norm="linf",
                                          **kw)

    # The semismooth Newton runs: forced, and under "auto" on a cell with
    # rows outside the unit ball (tests/test_torch_ssn_pipeline.py holds
    # both against the JAX package).
    def out_of_contract(run_seed):
        rng = np.random.default_rng(run_seed)

        def sample(T, rep=0):
            z = 3.0 * rng.normal(size=(T, 5))
            return z, np.sign(rng.normal(size=T)), None
        return sample

    for solver, fam in (("ssn", family), ("auto", out_of_contract)):
        audit = {}
        stats = pt_evaluate.evaluate_stream_exact(fam, solver=solver,
                                                  audit_out=audit, **kw)
        assert audit["cells_ssn"] == audit["cells"] == 1, (solver, audit)
        assert all(np.isfinite(v[0]).all() for v in stats.values())


@pytest.mark.parametrize("solver", ["auto", "xla"])
def test_estimate_g_exact_matches_jax_and_resumes(solver, tmp_path):
    cache = str(tmp_path / "g.json")
    kw = dict(runs=6, iters=1500, progress=False, solver=solver)
    got = pt_gt.estimate_g_exact((20, 40), cache_path=cache, device="cpu",
                                 **kw)
    want = jax_gt.estimate_g_exact((20, 40), **kw)
    for T in (20, 40):
        assert abs(got[T] - want[T]) <= 1e-9, T
    with open(cache) as f:
        saved = json.load(f)
    assert saved["_meta"]["key"]["kind"] == "g_exact"
    saved["20"] = 123.0
    with open(cache, "w") as f:
        json.dump(saved, f)
    again = pt_gt.estimate_g_exact((20, 40), cache_path=cache, device="cpu",
                                   **kw)
    assert again[20] == 123.0 and again[40] == got[40]


def test_exact_driver_end_to_end(tmp_path):
    cfg = ExperimentConfig(t_min=40, t_max=80, t_step=40, g_runs=4,
                           runs_override=2, replicates_override=2,
                           exact=True, exact_iters=1200, device="cpu",
                           out_dir=str(tmp_path), dpi=40)
    results = pt_driver.run_experiment(cfg)
    assert set(results["stats"]) == set(CASES)
    for stats in results["stats"].values():
        assert set(stats) == {"FTRL", "FTL (exact)"}
        for rec in stats.values():
            assert np.isfinite(np.asarray(rec["mean"], np.float64)).all()
    assert set(results["audit"]) == set(CASES)
    for seconds in results["exact_time_s"].values():
        assert set(seconds) == {"prepare", "solve_wait", "polish", "score",
                                "certified_score"}
        assert all(v >= 0.0 for v in seconds.values())
    assert results["device"] == {"type": "cpu"}
    for name in ("results_exact.json", "empirical_g_T_exact.png",
                 "algorithm_comparison_exact.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_exact_config_flags_and_refusals(tmp_path):
    cfg = config_from_args(["--exact", "--exact-solver", "kernel",
                            "--precision", "f32", "--exact-iters", "900",
                            "--exact-selection", "committed", "--norm", "l2",
                            "--device", "cpu"])
    assert (cfg.exact, cfg.exact_solver, cfg.exact_iters,
            cfg.exact_selection) == (True, "kernel", 900, "committed")
    plain = ExperimentConfig()
    assert plain.g_cache_key() == ExperimentConfig(
        exact_solver="kernel").g_cache_key()
    assert cfg.g_cache_key() != ExperimentConfig(
        exact=True, exact_solver="auto", exact_iters=900, precision="f32",
        device="cpu").g_cache_key()
    out = ["--out-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="--precision f32"):
        pt_driver.run_experiment(config_from_args(
            ["--exact", "--exact-solver", "kernel"] + out))
    with pytest.raises(ValueError, match="IEEE"):
        pt_driver.run_experiment(config_from_args(
            ["--exact", "--exact-admm-precision", "high"] + out))
