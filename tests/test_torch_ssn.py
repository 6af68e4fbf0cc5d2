"""The port's semismooth-Newton exact-FTL solver (``models/ssn.py``) against
the JAX package's (x64, on the CPU) and against independent oracles.

Bars and why:
  - the building blocks ``_ball_newton_step`` and ``_box_newton_step`` on
    well-conditioned random PSD batches: within 1e-12 of JAX (measured
    ~5e-16; the only differences are the order of a few sums);
  - ``ssn_all_prefixes`` at a fixed 1, 3 and 10 Newton steps (``tol=0``):
    X and ``mu`` within 1e-9 of JAX on every row that JAX itself
    reproduces under one-ulp changes of ``z``.  The other rows are
    rounding-determined in both packages: a prefix shorter than d
    interpolates its rows on a whole affine set (objective 0 on a
    continuum, the line search choosing among ties at 1e-15), and under the
    linf ball a singular Huber-zone Hessian leaves the box subproblem's
    direction to rounding (measured: JAX moves rows 26, 41, 45, 46 and 50 at
    10 steps under such changes, the port row 50);
  - the mirror of ``tests/test_ssn.py`` (SLSQP, HiGHS and the port's banded
    ADMM as oracles) at that file's bars, with one exception stated at
    ``test_ssn_fuzz_matches_admm_after_polish``.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linprog, minimize

import jax
import jax.numpy as jnp

from online_convex_optimization_tpu.models import ssn as jax_ssn
from online_convex_optimization_tpu_torch.models import ssn
from online_convex_optimization_tpu_torch.models.exact_ftl import (
    ExactFTL,
    _admm_all_prefixes,
)
from online_convex_optimization_tpu_torch.models.linear_regime import (
    certified_prefix_actions,
)
from online_convex_optimization_tpu_torch.models.polish import (
    objective,
    polish_prefix_actions,
    polish_solution,
)

torch.set_num_threads(1)


def _hard_instance(T=60, d=5, seed=0, scale=2.0):
    """Unclipped rows (||z|| ~ scale * sqrt(d) >> 1): outside the certified
    regime, so the iterative solvers run (``tests/test_ssn.py``)."""
    rng = np.random.default_rng(seed)
    z = scale * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d) + 0.5 * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def _solver(**kw):
    kw.setdefault("device", "cpu")
    return ExactFTL(**kw)


def _slsqp_best(z, y, tries=5, seed=99):
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(tries):
        r = minimize(lambda v: objective(z, y, v),
                     0.3 * rng.normal(size=z.shape[1]),
                     constraints=[{"type": "ineq",
                                   "fun": lambda v: 1 - np.dot(v, v)}],
                     method="SLSQP", options={"maxiter": 800,
                                              "ftol": 1e-14})
        if best is None or r.fun < best.fun:
            best = r
    return best.fun


def _lp_linf(z, y):
    T, d = z.shape
    A = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
    b = np.concatenate([y, -y])
    c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
    res = linprog(c, A_ub=A, b_ub=b, bounds=[(-1, 1)] * d + [(0, None)] * T,
                  method="highs")
    return res.x[:d], res.fun


# ------------------------------------------------- against the JAX package

def _psd_batch(seed, N=64, d=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, d, d))
    H = A @ A.transpose(0, 2, 1) + (10.0 ** rng.uniform(-2, 0, size=N)
                                     )[:, None, None] * np.eye(d)
    b = rng.normal(size=(N, d)) * (10.0 ** rng.uniform(-1, 1, size=N)
                                   )[:, None]
    return H, b


@pytest.mark.parametrize("step", ["ball", "box"])
def test_newton_steps_match_jax(step):
    H, b = _psd_batch(11 if step == "ball" else 12)
    port = ssn._ball_newton_step if step == "ball" else ssn._box_newton_step
    ref = (jax_ssn._ball_newton_step if step == "ball"
           else jax_ssn._box_newton_step)
    v, lam = port(*_t(H, b), 5)
    v_j, lam_j = ref(jnp.asarray(H), jnp.asarray(b), 5, jnp.float64)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-12, rtol=0)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), atol=1e-12,
                               rtol=0)
    # Both branches of the ball step are exercised.
    if step == "ball":
        assert 0 < int((lam.numpy() > 0).sum()) < len(lam)


FIXED_STEPS = (1, 3, 10)


@pytest.fixture(scope="module")
def jax_fixed_steps():
    """JAX x64's iterates of ``_hard_instance(T=60)`` after 1, 3 and 10
    steps, and the rows of each that move by more than 1e-9 when z moves by
    one ulp (four sign patterns); one step a call, so that each norm
    compiles twice."""
    z, y = _hard_instance(T=60)
    zs = [z] + [z * (1 + 2.0 ** -52 * np.random.default_rng(s).choice(
        [-1, 1], size=z.shape)) for s in range(4)]
    out = {}
    for norm in ("l2", "linf"):
        runs = []
        for zp in zs:
            st, seen = None, {}
            for k in range(1, max(FIXED_STEPS) + 1):
                _, _, st = jax_ssn.ssn_all_prefixes(
                    jnp.asarray(zp), jnp.asarray(y), iters=1, tol=0.0,
                    state0=st, norm=norm)
                if k in FIXED_STEPS:
                    seen[k] = tuple(np.asarray(a) for a in st)
            runs.append(seen)
        for k in FIXED_STEPS:
            X_ref = runs[0][k][0]
            unstable = set()
            for seen in runs[1:]:
                unstable |= set(np.flatnonzero(
                    np.abs(seen[k][0] - X_ref).max(-1) > 1e-9))
            out[norm, k] = runs[0][k], unstable
    return z, y, out


@pytest.mark.parametrize("norm", ["l2", "linf"])
@pytest.mark.parametrize("k", FIXED_STEPS)
def test_fixed_steps_match_jax(norm, k, jax_fixed_steps):
    z, y, ref = jax_fixed_steps
    (X_j, mu_j), unstable = ref[norm, k]
    X, res, (_, mu) = ssn.ssn_all_prefixes(*_t(z, y), iters=k, tol=0.0,
                                           norm=norm)
    assert X.dtype == res.dtype == mu.dtype == torch.float64
    assert X.shape == (60, 5) and mu.shape == (60, 1)
    # The unstable rows include every prefix shorter than d; only under the
    # linf ball, at 10 steps, do others join.
    assert set(range(4 if norm == "linf" else 2)) <= unstable
    assert k == 10 and norm == "linf" or max(unstable) < 4
    stable = np.asarray(sorted(set(range(60)) - unstable))
    np.testing.assert_allclose(X.numpy()[stable], X_j[stable], atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(mu.numpy()[stable], mu_j[stable], atol=1e-9,
                               rtol=0)


def test_ladder_argmin_and_top_k_order_match_jax():
    """The line search's argmin takes the first minimum on ties and the
    first NaN on NaN rows, as ``jnp.argmin``; the linf polish's selection
    takes ``jax.lax.top_k(-score, K)``'s indices in its order, with the
    masked (+inf) entries of a prefix shorter than K in index order."""
    f = np.array([[3.0, 1.0, 1.0, 2.0], [np.nan, 0.5, np.nan, 0.5],
                  [2.0, 2.0, 2.0, 2.0], [0.0, -0.0, 1.0, np.nan]]).T
    np.testing.assert_array_equal(torch.argmin(torch.from_numpy(f), dim=0),
                                  np.asarray(jnp.argmin(jnp.asarray(f),
                                                        axis=0)))
    rng = np.random.default_rng(3)
    score = np.round(rng.random((6, 30)), 1)          # many ties
    score[:, 5:] = np.where(np.arange(6)[:, None] < 3, np.inf,
                            score[:, 5:])             # prefixes of 5 rows
    for K in (12, 30):
        got = ssn._first_k_smallest(torch.from_numpy(score), K).numpy()
        want = np.asarray(jax.lax.top_k(-jnp.asarray(score), K)[1])
        np.testing.assert_array_equal(got, want)


def test_stacked_bands_and_continuation():
    """Bands stacked on a leading axis give each band's own call, and a
    call continued from its state equals one call of the summed steps (the
    iteration is Markov in (X, mu))."""
    z, y = _hard_instance(T=60, seed=4)
    zt, yt = _t(z, y)
    zb, yb = torch.stack([zt, zt.flip(0)]), torch.stack([yt, yt.flip(0)])
    X, res, (Xs, mu) = ssn.ssn_all_prefixes(zb, yb, iters=12, tol=1e-4,
                                            band_lo=[0, 20, 40],
                                            band_rows=20)
    assert X.shape == (3, 2, 20, 5) and res.shape == (3, 2, 20)
    for bi, lo in enumerate((0, 20, 40)):
        for b in range(2):
            Xo, ro, (_, muo) = ssn.ssn_all_prefixes(
                zb[b], yb[b], iters=12, tol=1e-4, band_lo=lo, band_rows=20)
            np.testing.assert_allclose(X[bi, b].numpy(), Xo.numpy(),
                                       atol=1e-12, rtol=0)
            np.testing.assert_allclose(mu[bi, b].numpy(), muo.numpy(),
                                       atol=1e-12, rtol=0)
            np.testing.assert_allclose(res[bi, b].numpy(), ro.numpy(),
                                       atol=1e-12, rtol=0)
    _, _, st = ssn.ssn_all_prefixes(zt, yt, iters=4, tol=0.0, band_lo=20,
                                    band_rows=20)
    Xc, rc, stc = ssn.ssn_all_prefixes(zt, yt, iters=5, tol=0.0, state0=st,
                                       band_lo=20, band_rows=20)
    Xl, rl, stl = ssn.ssn_all_prefixes(zt, yt, iters=9, tol=0.0, band_lo=20,
                                       band_rows=20)
    assert torch.equal(Xc, Xl) and torch.equal(rc, rl)
    assert torch.equal(stc[1], stl[1])
    counts = {}
    ssn.ssn_all_prefixes(zt, yt, iters=7, tol=0.0, counts=counts)
    assert counts == {"steps": 7}


# --------------------------------------- mirror of tests/test_ssn.py

def test_ssn_full_matches_slsqp_after_polish():
    z, y = _hard_instance(seed=1)
    x, res, _ = ssn.ssn_full(*_t(z, y), iters=120, tol=1e-5)
    assert x.shape == (5,) and float(res) <= 1e-3
    x_pol = polish_solution(z, y, x.numpy(), "l2")
    assert objective(z, y, x_pol) <= _slsqp_best(z, y) + 1e-8
    assert np.linalg.norm(x_pol) <= 1.0 + 1e-9


def test_ssn_prefixes_match_admm_after_polish():
    """Both general solvers and the shared polish land on the same optima
    for every prefix of a hard instance."""
    z, y = _hard_instance(T=40, seed=2)
    a_s = _solver(d=5, T_max=40, norm="l2", method="ssn", iters=200,
                  allow_linear=False).prefix_actions(z, y)
    a_a = _solver(d=5, T_max=40, norm="l2", iters=6000,
                  allow_linear=False).prefix_actions(z, y)
    for p in range(1, 41):
        fs = objective(z[:p], y[:p], a_s[p])
        fa = objective(z[:p], y[:p], a_a[p])
        assert abs(fs - fa) <= 3e-6, p
        assert np.linalg.norm(a_s[p]) <= 1.0 + 1e-9


def test_ssn_banded_consistency():
    """Band solves agree with the full-batch solve at the shared
    tolerance."""
    z, y = _hard_instance(T=60, seed=3)
    zt, yt = _t(z, y)
    X_full, r_full, _ = ssn.ssn_all_prefixes(zt, yt, iters=200, tol=1e-5)
    assert float(r_full.max()) <= 1e-4
    for lo in (0, 20, 40):
        Xb, _, _ = ssn.ssn_all_prefixes(zt, yt, iters=200, tol=1e-5,
                                        band_lo=lo, band_rows=20)
        for k in range(20):
            p = lo + k + 1
            fb = objective(z[:p], y[:p], Xb[k].numpy())
            ff = objective(z[:p], y[:p], X_full[p - 1].numpy())
            assert abs(fb - ff) <= 1e-4, p


def test_ssn_contract_data_sanity():
    """On certified data the SSN agrees with the closed form."""
    rng = np.random.default_rng(4)
    z = rng.normal(size=(30, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    y = np.sign(z @ rng.normal(size=5) + 0.3 * rng.normal(size=30))
    y[y == 0] = 1.0
    acts = certified_prefix_actions(z, y, "l2")
    assert acts is not None
    X, _, _ = ssn.ssn_all_prefixes(*_t(z, y), iters=200, tol=1e-5)
    for p in (1, 10, 30):
        assert objective(z[:p], y[:p], X[p - 1].numpy()) <= \
            objective(z[:p], y[:p], acts[p]) + 1e-4, p


FUZZ_SEEDS = (5, 7, 8, 9)


def _fuzz_instance(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(20, 90))
    scale = float(rng.uniform(0.5, 4.0))
    z = scale * rng.normal(size=(T, 5))
    y = np.sign(z @ rng.normal(size=5)
                + rng.uniform(0, 0.8) * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


@pytest.fixture(scope="module")
def fuzz_solves():
    """The fuzz instances zero-padded to one length and solved in one
    batch by each solver, every member stopping on its own (padded rows
    are inert: a prefix past T solves prefix T's problem)."""
    inst = [_fuzz_instance(s) for s in FUZZ_SEEDS]
    T_max = max(z.shape[0] for z, _ in inst)
    zb = np.zeros((len(inst), T_max, 5))
    yb = np.zeros((len(inst), T_max))
    for i, (z, y) in enumerate(inst):
        zb[i, :len(y)], yb[i, :len(y)] = z, y
    zt, yt = _t(zb, yb)
    Xs, rs, _ = ssn.ssn_all_prefixes(zt, yt, iters=2000, tol=1e-5)
    Xa, _, _ = _admm_all_prefixes(zt, yt, norm="l2", iters=20000, tol=1e-6,
                                  check_every=200)
    return {s: (z, y, Xs[i, :len(y)].numpy(), rs[i, :len(y)].numpy(),
                Xa[i, :len(y)].numpy())
            for i, (s, (z, y)) in enumerate(zip(FUZZ_SEEDS, inst))}


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_ssn_fuzz_matches_admm_after_polish(seed, fuzz_solves):
    """Randomized (scale, T, noise) out-of-contract instances, the slow-tail
    seeds among them (~1e3 Newton steps): post-polish parity with the
    port's banded ADMM at ``tests/test_ssn.py``'s 3e-6.

    The certificate is held at JAX's 1e-4 on the prefixes longer than d
    only.  On seed 7 the prefix of length 5 (= d: a boundary solution with
    four interpolated rows) reaches a fixed point at the continuation floor
    mu = 1e-6 whose duality gap depends on the iterate at the 1e-10 level:
    the port's stays near 1e-3 to the 2000-step cap, JAX's is 9.6e-6 after
    1127 steps (its polished objective is held below like every other).
    No step differs: the port's ball step equals the JAX package's
    evaluated operation by operation in every bit
    (``test_ball_step_equals_jax_op_by_op_at_the_seed7_fixed_point``);
    jitted XLA on the CPU contracts a * b + c into fused multiply-adds, a
    rounding the port does not imitate."""
    z, y, Xs, rs, Xa = fuzz_solves[seed]
    T = len(y)
    assert float(rs[5:].max()) <= 1e-4
    a_s = polish_prefix_actions(z, y, np.concatenate(
        [np.zeros((1, 5)), Xs]), "l2")
    a_a = polish_prefix_actions(z, y, np.concatenate(
        [np.zeros((1, 5)), Xa]), "l2")
    for p in range(1, T + 1):
        assert abs(objective(z[:p], y[:p], a_s[p])
                   - objective(z[:p], y[:p], a_a[p])) <= 3e-6, p


def test_ball_step_equals_jax_op_by_op_at_the_seed7_fixed_point():
    """At the fixed point of the seed-7 prefix of length d (mu at its floor
    1e-6, IRLS weights up to 1 / (2 mu)), the port's ball step on the IRLS
    model equals the JAX package's evaluated operation by operation
    (``jax.disable_jit``) in every bit, v and the multiplier, through all
    its secular iterations: the deviation the fuzz test exempts is the
    rounding of JAX's compiled step, not a step of the port's."""
    z, y = _fuzz_instance(7)
    T, d, r = len(y), 5, 4
    _, _, (X, mu) = jax_ssn.ssn_all_prefixes(jnp.asarray(z), jnp.asarray(y),
                                             iters=60, tol=1e-5)
    X, mu = np.asarray(X), np.asarray(mu)
    assert mu[r, 0] == 0.1 * 1e-5
    R = (z @ X[r] - y) * (np.arange(T) <= r)
    w = (np.arange(T) <= r) / (2 * np.maximum(np.abs(R), mu[r, 0]))
    psi = np.clip(R / mu[r, 0], -1, 1) * (np.arange(T) <= r)
    H = np.einsum("t,ti,tj->ij", w, z, z)[None]
    b = (0.5 * psi @ z - H[0] @ X[r])[None]
    v, lam = ssn._ball_newton_step(*_t(H, b), d)
    with jax.disable_jit():
        vj, lamj = jax_ssn._ball_newton_step(jnp.asarray(H), jnp.asarray(b),
                                             d, jnp.float64)
    assert np.array_equal(v.numpy(), np.asarray(vj))
    assert np.array_equal(lam.numpy(), np.asarray(lamj))
    assert 0.0 < float(lam[0]) and abs(np.linalg.norm(v.numpy()) - 1) < 1e-8


def test_ssn_failure_contract_and_validation():
    """A starved Newton budget surfaces through the ADMM's raise contract;
    the SSN rejects the l1 ball."""
    z, y = _hard_instance(T=40, seed=5)
    starved = _solver(d=5, T_max=40, norm="l2", method="ssn", iters=1,
                      fail_tol=1e-6, allow_linear=False)
    with pytest.raises(RuntimeError, match="failed to converge"):
        starved.solve_full(z, y)
    with pytest.raises(ValueError, match="l2"):
        _solver(d=5, T_max=40, norm="l1", method="ssn")
    with pytest.raises(ValueError, match="method"):
        _solver(d=5, T_max=40, method="nope")


def test_box_newton_step_matches_reference_qp():
    """The linf model subproblem solver reaches the reference box-QP
    optimum across a conditioning fuzz."""
    rng = np.random.default_rng(11)
    d, N = 5, 64
    Hs, bs = [], []
    for _ in range(N):
        A = rng.normal(size=(d, d)) * (10.0 ** rng.uniform(-2, 1))
        Hs.append(A @ A.T + 10.0 ** rng.uniform(-6, 0) * np.eye(d))
        bs.append(rng.normal(size=d) * (10.0 ** rng.uniform(-1, 1)))
    v = ssn._box_newton_step(*_t(np.stack(Hs), np.stack(bs)), d)[0].numpy()
    assert np.abs(v).max() <= 1.0 + 1e-12
    bad = 0
    for i in range(N):
        f = lambda x: 0.5 * x @ Hs[i] @ x + bs[i] @ x
        ref = minimize(f, np.zeros(d), jac=lambda x: Hs[i] @ x + bs[i],
                       bounds=[(-1, 1)] * d, method="L-BFGS-B",
                       options={"ftol": 1e-15, "gtol": 1e-12,
                                "maxiter": 500})
        if (f(v[i]) - ref.fun) / (1.0 + abs(ref.fun)) > 1e-6:
            bad += 1
    assert bad <= 2, f"{bad}/{N} box QPs solved poorly"


def test_ssn_linf_matches_lp_objectives():
    """linf-ball SSN prefix solves hit the HiGHS LP optima; the duality gap
    is rigorous (never below the true suboptimality)."""
    rng = np.random.default_rng(3)
    T, d = 40, 5
    z = 2.0 * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d) + 0.5 * rng.normal(size=T))
    y[y == 0] = 1.0
    X, res, _ = ssn.ssn_all_prefixes(*_t(z, y), iters=300, tol=1e-6,
                                     norm="linf")
    X, res = X.numpy(), res.numpy()
    for t in range(1, T + 1):
        assert np.abs(X[t - 1]).max() <= 1.0 + 1e-10
        f_ssn = 0.5 * np.abs(z[:t] @ X[t - 1] - y[:t]).sum()
        _, f_lp = _lp_linf(z[:t], y[:t])
        true_sub = (f_ssn - f_lp) / (1.0 + f_ssn)
        assert res[t - 1] >= true_sub - 1e-9, (t, res[t - 1], true_sub)
        if res[t - 1] <= 2e-4:
            assert f_ssn <= f_lp + 2e-4 * (1.0 + f_lp) + 1e-9, t
    assert (res <= 2e-4).mean() >= 0.9
    assert np.median(res) <= 1e-6


def test_ssn_l1_norm_raises():
    with pytest.raises(NotImplementedError, match="l1"):
        ssn.ssn_all_prefixes(torch.zeros((4, 5)), torch.zeros(4), norm="l1")
