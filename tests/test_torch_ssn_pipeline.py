"""The port's semismooth Newton (``models/ssn.py``) through its entry points:
the exact pipeline (``solver="ssn"`` and ``"auto"``), ``ExactFTL`` under the
linf ball, and float32 callers, against the JAX package (x64, on the CPU),
the port's banded ADMM and HiGHS.

Bars and why:
  - ``evaluate_stream_exact(solver="ssn")``: within 1e-9 of the JAX
    package's ``solver="ssn"`` (measured 8.3e-10, on the FTL statistic: the
    SSN iterates agree, and the polish's selection on a degenerate optimal
    face moves the replayed regret at that scale) and within 3e-6 of the
    port's ``"xla"`` route (the bar of the JAX package's own
    ``test_evaluate_stream_exact_ssn_matches_xla``); the audit dicts equal;
  - ``"auto"`` on out-of-contract data equals ``"ssn"`` at atol 0 (the same
    solves), with the JAX package's audit;
  - the JAX package's float32 "comp mode" is not ported: a float32 caller
    gets the float64 solve of its values, bit for bit, certified on every
    prefix at 2e-4, and its duality gap is sound against the JAX x64
    oracle on the same values.
"""

import numpy as np
import torch
from scipy.optimize import linprog

import jax.numpy as jnp

from online_convex_optimization_tpu.data.sequences import CASES as JAX_CASES
from online_convex_optimization_tpu.experiments import evaluate as jax_evaluate
from online_convex_optimization_tpu.models import ssn as jax_ssn
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.experiments import evaluate
from online_convex_optimization_tpu_torch.models import ssn
from online_convex_optimization_tpu_torch.models.exact_ftl import ExactFTL

torch.set_num_threads(1)


def _hard_instance(T=60, d=5, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    z = scale * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d) + 0.5 * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


def _ooc_builder(rep_stride):
    """Out-of-contract family: z = 2 N(0, I), y = sign(z.w + 0.3 noise)."""
    def builder(run_seed=0):
        def sampler(T, rep=0):
            rng = np.random.default_rng(run_seed + rep_stride * rep)
            z = 2.0 * rng.normal(size=(T, 5))
            y = np.sign(z @ rng.normal(size=5) + 0.3 * rng.normal(size=T))
            y[y == 0] = 1.0
            return z, y
        return sampler
    return builder


class _Counting:
    """Counts the calls of ``ssn.ssn_all_prefixes``."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = ssn.ssn_all_prefixes

        def counting(*a, **k):
            self.n += 1
            return orig(*a, **k)
        monkeypatch.setattr(ssn, "ssn_all_prefixes", counting)


def test_evaluate_stream_exact_ssn_matches_jax_and_xla():
    title = "Random i.i.d. (separable)"
    kw = dict(T_grid=[30, 50], runs=1, replicates=2, iters=1200,
              dtype=np.float64, stream_name="ssn", progress=False)
    audit, audit_jax = {}, {}
    got = evaluate.evaluate_stream_exact(CASES[title], solver="ssn",
                                         audit_out=audit, device="cpu", **kw)
    want = jax_evaluate.evaluate_stream_exact(JAX_CASES[title], solver="ssn",
                                              audit_out=audit_jax, **kw)
    xla = evaluate.evaluate_stream_exact(CASES[title], solver="xla",
                                         device="cpu", **kw)
    assert audit == audit_jax and audit["cells_ssn"] == audit["cells"] == 2
    for key in want:
        np.testing.assert_allclose(got[key][0], want[key][0], atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(got[key][1], want[key][1], atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(got[key][0], xla[key][0], atol=3e-6,
                                   rtol=0)


def test_evaluate_stream_exact_auto_routes_ooc_to_ssn(monkeypatch):
    """``"auto"`` sends out-of-contract cells (rows outside the unit ball)
    to the semismooth Newton and reproduces ``"ssn"`` exactly."""
    builder = _ooc_builder(31)
    kw = dict(T_grid=[24, 40], runs=1, replicates=2, iters=1200,
              dtype=np.float64, stream_name="ooc-auto", progress=False)
    calls = _Counting(monkeypatch)
    audit, audit_jax = {}, {}
    s_a = evaluate.evaluate_stream_exact(builder, solver="auto",
                                         audit_out=audit, device="cpu", **kw)
    assert calls.n > 0, "auto did not route the OOC cells through the SSN"
    jax_evaluate.evaluate_stream_exact(builder, solver="auto",
                                       audit_out=audit_jax, **kw)
    assert audit == audit_jax
    assert audit["cells_ssn"] == 2 and audit["cells_admm"] == 0
    s_s = evaluate.evaluate_stream_exact(builder, solver="ssn", device="cpu",
                                         **kw)
    for key in s_s:
        np.testing.assert_allclose(s_a[key][0], s_s[key][0], rtol=0, atol=0)
        np.testing.assert_allclose(s_a[key][1], s_s[key][1], rtol=0, atol=0)


def test_ssn_f32_inputs_solve_in_f64():
    """Replaces the JAX package's f32 certificate test: float32 inputs are
    upcast, so they solve to the bits of the float64 solve of the same
    values; every prefix certifies at 2e-4, and the certificate is sound
    against the JAX x64 oracle on those values."""
    z, y = _hard_instance(T=96, seed=3)
    zf = torch.from_numpy(z.astype(np.float32))
    yf = torch.from_numpy(y.astype(np.float32))
    X32, res32, st32 = ssn.ssn_all_prefixes(zf, yf, iters=20, tol=0.0)
    X64, res64, st64 = ssn.ssn_all_prefixes(zf.double(), yf.double(),
                                            iters=20, tol=0.0)
    assert X32.dtype == res32.dtype == st32[1].dtype == torch.float64
    assert torch.equal(X32, X64) and torch.equal(res32, res64)
    assert torch.equal(st32[1], st64[1])
    X, res, _ = ssn.ssn_all_prefixes(zf, yf, iters=800, tol=1e-5)
    res = res.numpy()
    assert res.max() <= 2e-4
    z64, y64 = zf.double().numpy(), yf.double().numpy()
    X_o, res_o, _ = jax_ssn.ssn_all_prefixes(
        jnp.asarray(z64), jnp.asarray(y64), iters=2000, tol=1e-7)
    assert float(np.max(np.asarray(res_o))) <= 1e-5
    m = np.tril(np.ones((96, 96)))

    def fvals(X):
        return 0.5 * (np.abs(np.asarray(X, np.float64) @ z64.T - y64) * m
                      ).sum(1)

    fstar = fvals(X_o)
    sub = (fvals(X.numpy()) - fstar) / (1.0 + fstar)
    assert np.all(sub <= res + 1e-6), np.flatnonzero(sub > res + 1e-6)


def test_auto_routes_ooc_to_ssn_with_f32_dtype(monkeypatch):
    """Replaces the JAX package's f32 routing test: a float32 pipeline
    sends out-of-contract cells to the SSN (solved in float64) as well."""
    calls = _Counting(monkeypatch)
    audit = {}
    stats = evaluate.evaluate_stream_exact(
        _ooc_builder(7), T_grid=[24], runs=1, replicates=1, iters=1200,
        dtype=np.float32, stream_name="ooc-auto-f32", progress=False,
        solver="auto", audit_out=audit, device="cpu")
    assert calls.n > 0, "auto did not route the OOC cells to the SSN"
    assert audit["cells_ssn"] > 0 and audit["cells_admm"] == 0, audit
    assert audit["replicates_dropped"] == 0
    assert all(np.isfinite(v[0]).all() for v in stats.values())


def _lp_linf_objective(z, y):
    T, d = z.shape
    A = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
    c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
    return linprog(c, A_ub=A, b_ub=np.concatenate([y, -y]),
                   bounds=[(-1, 1)] * d + [(0, None)] * T,
                   method="highs").fun


def test_exact_ftl_ssn_linf_end_to_end():
    """``ExactFTL(method="ssn", norm="linf")`` gives LP-grade prefix
    objectives through prefix_actions and the polish (the bars of the JAX
    package's test of the same name)."""
    rng = np.random.default_rng(5)
    T, d = 28, 5
    z = 1.5 * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d))
    y[y == 0] = 1.0
    m = ExactFTL(d=d, T_max=T, norm="linf", method="ssn", fail_tol=3e-2,
                 device="cpu")
    acts = m.prefix_actions(z, y)
    good = 0
    for t in range(1, T + 1):
        f_m = 0.5 * np.abs(z[:t] @ acts[t] - y[:t]).sum()
        f_lp = _lp_linf_objective(z[:t], y[:t])
        assert f_m <= f_lp + 3e-2 * (1 + f_lp), (t, f_m, f_lp)
        good += f_m <= f_lp + 1e-6 + 1e-6 * f_lp
    assert good >= 0.9 * T, good


def test_fidelity_report_is_the_jax_tools(tmp_path):
    """The ported figure-fidelity audit gives the JAX tool's report on the
    committed ``results/results.json``, and its default ``--out`` is not
    the committed ``results/figure_fidelity.md``."""
    import os

    from online_convex_optimization_tpu.experiments import (
        fidelity as jax_fidelity)
    from online_convex_optimization_tpu_torch.experiments import fidelity

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = os.path.join(root, "results", "results.json")
    assert fidelity.audit(results) == jax_fidelity.audit(results)
    out = tmp_path / "report.md"
    assert fidelity.main(["--results", results, "--out", str(out)]) == \
        out.read_text()
    default = fidelity.main.__code__.co_consts
    assert "results/figure_fidelity.md" not in default
