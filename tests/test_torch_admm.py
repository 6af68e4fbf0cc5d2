"""Kernel K10's plain version (``ops/admm.py``) against the JAX package's
Pallas kernel in interpret mode (``ops/pallas_admm.py``).

Bars:
  - 300 fixed iterations at B = 2, T = 70: X within 2e-6, residuals within
    1e-5, the bars of ``tests/test_pallas_admm.py`` (kernel vs XLA path);
    the two compute the same f32 arithmetic in another reduction order;
  - continuation (100 + 150 iterations against 250): bit for bit, in the
    port and from a JAX state (``testing/from_jax.py::
    admm_state_from_jax``) within 2e-6 of the JAX 250-iteration run;
  - per-row exit: rows solved in a subset of the replicates are the same
    rows bit for bit;
  - at tol > 0, after the host polish (both scaled into the ball in f64
    first, ``admm.feasible_actions``): every prefix objective within 3e-6
    of the JAX kernel's, the JAX package's own cross-path bar
    (``tests/test_pallas_admm.py``): the port's rows stop on their own
    residual, the JAX kernel's on their 128-row block's;
  - past the register instances' 4,096 entries (the rows the long-row
    instance K10l takes on the card): T = 4,160, 3 fixed iterations,
    against the JAX XLA path at the same bars (the interpret-mode kernel
    takes minutes there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_convex_optimization_tpu.models.exact_ftl import (
    _admm_all_prefixes as jax_admm_all_prefixes,
)
from online_convex_optimization_tpu.ops.pallas_admm import (
    admm_all_prefixes_l2 as jax_kernel,
)
from online_convex_optimization_tpu_torch.models.polish import (
    objective,
    polish_prefix_actions,
)
from online_convex_optimization_tpu_torch.ops import admm
from online_convex_optimization_tpu_torch.testing.from_jax import (
    admm_state_from_jax,
    to_torch,
)

torch.set_num_threads(1)


def _batch(B, T, d=5, seed=0, noise=0.3):
    zs, ys = [], []
    for b in range(B):
        r = np.random.default_rng(seed + b)
        z = r.normal(size=(T, d))
        z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
        u = r.normal(size=d)
        u /= np.linalg.norm(u)
        zs.append(z.astype(np.float32))
        ys.append(np.sign(z @ u + noise * r.normal(size=T)).astype(np.float32))
    return np.stack(zs), np.stack(ys)


def _port(z, y, **kw):
    return admm.admm_all_prefixes_l2(torch.from_numpy(z), torch.from_numpy(y),
                                     **kw)


@pytest.fixture(scope="module")
def fixed300():
    z, y = _batch(2, 70)
    Xj, rj, stj = jax_kernel(jnp.asarray(z), jnp.asarray(y), iters=300,
                             tol=0.0, interpret=True)
    return z, y, (np.asarray(Xj), np.asarray(rj), stj)


def test_plain_matches_jax_kernel_fixed_iterations(fixed300):
    z, y, (Xj, rj, _) = fixed300
    X, res, state = _port(z, y, iters=300, tol=0.0)
    assert X.shape == (2, 70, 5) and res.shape == (2, 70)
    assert [tuple(a.shape) for a in state] == [(140, 70)] * 2 + [(140, 5)] * 3
    np.testing.assert_allclose(X.numpy(), Xj, atol=2e-6, rtol=0)
    np.testing.assert_allclose(res.numpy(), rj, atol=1e-5, rtol=0)


def test_plain_matches_jax_xla_path_fixed_iterations():
    z, y = _batch(2, 40, seed=4)
    X, res, _ = _port(z, y, iters=300, tol=0.0)
    for b in range(2):
        Xx, rx, _ = jax_admm_all_prefixes(jnp.asarray(z[b]), jnp.asarray(y[b]),
                                          norm="l2", iters=300, tol=0.0)
        np.testing.assert_allclose(X[b].numpy(), np.asarray(Xx), atol=2e-6,
                                   rtol=0)
        np.testing.assert_allclose(res[b].numpy(), np.asarray(rx), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("tol", [0.0, 2e-4])
def test_plain_continuation_is_bit_for_bit(tol):
    z, y = _batch(1, 40, seed=3)
    _, _, st = _port(z, y, iters=100, tol=tol)
    Xc, rc, stc = _port(z, y, iters=150, tol=tol, state0=st)
    Xl, rl, stl = _port(z, y, iters=250, tol=tol)
    if tol == 0.0:
        assert torch.equal(Xc, Xl) and torch.equal(rc, rl)
        assert all(torch.equal(a, b) for a, b in zip(stc, stl))
    else:
        # Every row runs at least one block more from a converged state.
        assert float(rc.max()) <= tol and float(rl.max()) <= tol


@pytest.mark.parametrize("form", ["kernel", "xla"])
def test_jax_state_continues_in_the_port(form):
    z, y = _batch(1, 40, seed=3)
    if form == "kernel":
        _, _, st = jax_kernel(jnp.asarray(z), jnp.asarray(y), iters=100,
                              tol=0.0, interpret=True)
        Xl, _, _ = jax_kernel(jnp.asarray(z), jnp.asarray(y), iters=250,
                              tol=0.0, interpret=True)
        Xl = np.asarray(Xl)
    else:
        _, _, st = jax_admm_all_prefixes(jnp.asarray(z[0]), jnp.asarray(y[0]),
                                         norm="l2", iters=100)
        Xl, _, _ = jax_admm_all_prefixes(jnp.asarray(z[0]), jnp.asarray(y[0]),
                                         norm="l2", iters=250)
        Xl = np.asarray(Xl)[None]
    state0 = to_torch(admm_state_from_jax(st, B=1, T=40, d=5), "cpu")
    Xc, _, _ = _port(z, y, iters=150, tol=0.0, state0=state0)
    np.testing.assert_allclose(Xc.numpy(), Xl, atol=2e-6, rtol=0)


def test_per_row_exit_subset_is_bit_for_bit():
    z, y = _batch(3, 60, seed=11)
    X, res, st = _port(z, y, iters=3000, tol=2e-4)
    X1, res1, st1 = _port(z[1:2], y[1:2], iters=3000, tol=2e-4)
    assert torch.equal(X[1], X1[0]) and torch.equal(res[1], res1[0])
    assert torch.equal(st[0][60:120], st1[0])
    assert float(res.max()) <= 2e-4


def test_entries_past_a_rows_length_stay_zero():
    z, y = _batch(2, 30, seed=5)
    _, _, (s, u, _, _, _) = _port(z, y, iters=200, tol=0.0)
    past = torch.arange(30)[None, :] > torch.arange(30).repeat(2)[:, None]
    assert bool((s[past] == 0).all()) and bool((u[past] == 0).all())
    assert bool((s[~past] != 0).any())


def test_prologue_packs_the_inverted_factor():
    z, _ = _batch(2, 20, d=3, seed=6)
    zt = torch.from_numpy(z).double()
    Lpk = admm.admm_prologue(zt)
    A = torch.cumsum(zt[:, :, :, None] * zt[:, :, None, :], 1) + torch.eye(3)
    L = torch.linalg.cholesky(A).reshape(40, 3, 3)
    for j in range(3):
        for k in range(j + 1):
            want = 1.0 / L[:, j, j] if j == k else L[:, j, k]
            torch.testing.assert_close(Lpk[:, admm.tril_index(j, k)], want,
                                       rtol=0, atol=1e-14)


def test_polished_tol_solve_matches_jax_kernel():
    z, y = _batch(2, 60, seed=7)
    Xj, rj, _ = jax_kernel(jnp.asarray(z), jnp.asarray(y), iters=6000,
                           tol=2e-4, interpret=True)
    X, res, _ = _port(z, y, iters=6000, tol=2e-4)
    assert float(res.max()) <= 2e-4 and float(np.asarray(rj).max()) <= 2e-4
    for b in range(2):
        zb, yb = z[b].astype(np.float64), y[b].astype(np.float64)
        acts = [polish_prefix_actions(
            zb, yb, np.concatenate([np.zeros((1, 5)),
                                    admm.feasible_actions(a)[b]]), "l2")
            for a in (np.asarray(Xj), X)]
        for p in range(1, 61):
            fj, fp = (objective(zb[:p], yb[:p], a[p]) for a in acts)
            assert abs(fp - fj) <= 3e-6, (b, p)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    z, y = _batch(1, 10)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    with pytest.raises(TypeError, match="float32"):
        admm.admm_all_prefixes_l2(zt.double(), yt.double())
    with pytest.raises(ValueError, match=r"z \(B, T, d\)"):
        admm.admm_all_prefixes_l2(zt[0], yt[0])
    with pytest.raises(ValueError, match="state0 s"):
        admm.admm_all_prefixes_l2(zt, yt, state0=(torch.zeros(3, 3),) * 5)
    with pytest.raises(ValueError, match=r"d <= 8"):
        admm.check_kernel_envelope(100, 9)
    with pytest.raises(ValueError, match=r"d <= 8"):
        admm.check_kernel_envelope(16384, 9)
    # Any T has an instance: rows past 4,096 entries take K10l.
    for T in (4096, 4097, 16384):
        admm.check_kernel_envelope(T, 8)
    # The plain version takes what the kernel does not: d = 9 on the CPU.
    z9, y9 = _batch(1, 12, d=9)
    X, _, _ = _port(z9, y9, iters=50, tol=0.0)
    assert X.shape == (1, 12, 9) and bool(torch.isfinite(X).all())
    assert admm.LAUNCHES == 0


def test_kernel_source_is_built_and_hashed_with_the_rest():
    from online_convex_optimization_tpu_torch.utils import cuda_build
    assert any(p.endswith("admm_kernel.cu") for p in cuda_build._sources())
    argtypes = cuda_build._SIGNATURES["oco_admm_all_prefixes_f32"]
    # 8 inputs, 9 scalars, 6 outputs, the stream, the launch counts (all
    # of K10's and K10l's)
    assert len(argtypes) == 25


def test_plain_matches_jax_xla_path_past_the_register_rows():
    """T = 4,160: the rows past 4,096 entries, which K10l takes on the
    card, against the JAX package's XLA path on the same inputs."""
    z, y = _batch(1, 4160, seed=8)
    X, res, (s, _, _, _, _) = _port(z, y, iters=3, tol=0.0)
    Xx, rx, _ = jax_admm_all_prefixes(jnp.asarray(z[0]), jnp.asarray(y[0]),
                                      norm="l2", iters=3, tol=0.0)
    np.testing.assert_allclose(X[0].numpy(), np.asarray(Xx), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(res[0].numpy(), np.asarray(rx), atol=1e-5,
                               rtol=0)
    assert bool((s[-1] != 0).any()) and s.shape == (4160, 4160)


@pytest.mark.parametrize("T,want", [(1, [8]), (2048, [8]), (2049, [16, 8]),
                                    (4096, [16, 8]),
                                    (4097, ["resident", 16, 8]),
                                    (16384, ["long", "resident", 16, 8]),
                                    (8192, ["resident", 16, 8]),
                                    (8193, ["long", "resident", 16, 8])])
def test_row_to_instance_map(T, want):
    """The wrapper's mirror of the C entry's map of rows to instances, in
    launch order, and its boundaries as the CUDA source states them."""
    import os
    import re
    from online_convex_optimization_tpu_torch.utils import cuda_build
    assert admm.kernel_instances(T) == want
    src = {}
    for name in ("admm_kernel.cu", "oco_admm.cuh"):
        with open(os.path.join(cuda_build.SRC_DIR, name)) as f:
            src[name] = f.read()
    assert re.search(r"constexpr int kSplit = 2048;", src["admm_kernel.cu"])
    assert re.search(r"constexpr int kLongRows = 32 \* OCO_ADMM_WARPS \* 16;",
                     src["oco_admm.cuh"])
    assert re.search(r"#define OCO_ADMM_WARPS 8\b", src["oco_admm.cuh"])
    assert admm.LONG_ROWS == 32 * 8 * 16
    with open(os.path.join(cuda_build.SRC_DIR, "admm_long_kernel.cu")) as f:
        assert re.search(r"constexpr int kResidentRows = %d;"
                         % admm.RESIDENT_ROWS, f.read())
