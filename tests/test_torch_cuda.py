"""Kernels K1-K9 on the card against their plain PyTorch versions; the
sweeps, the stream, the packed game (K3, K3e) and the generation-fused
game (K7) against K1 and K2; K8's comparator against K9; the quadratic
study against its CPU run.

Needs a CUDA device and nvcc; skipped elsewhere.  This file imports only
torch, numpy and the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.experiments.quadratic_study import (
    evaluate_quadratic_stream,
)
from online_convex_optimization_tpu_torch.ops import game, smart, trs
from online_convex_optimization_tpu_torch.testing.golden import (
    golden_simulate_alg,
    golden_simulate_smart,
)

pytestmark = pytest.mark.requires_cuda
torch.set_num_threads(1)

TOL = {torch.float64: 1e-9, torch.float32: 5e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(B, T, d, seed, *, contract=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        y = rng.normal(size=(B, T))
    lengths = rng.integers(0, T + 1, size=B)
    lengths[0] = T
    return z, y, lengths


def _to(arrays, device, dtype):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3])
@pytest.mark.parametrize("contract", [True, False])
def test_regret_kernel_matches_plain(cuda, dtype, d, contract):
    z, y, lengths = _batch(300, 129, d, seed=d, contract=contract)
    flags = np.arange(300) % 2
    eta = np.linspace(0.3, 2.0, 300)
    zt, yt = _to((z, y), cuda, dtype)
    before = game.LAUNCHES
    got = game.regrets_fused(zt, yt, flags, eta, lengths)
    torch.cuda.synchronize()
    assert game.LAUNCHES == before + 1
    fl, et, ln = (game.per_sequence(flags, 300, torch.int32, cuda),
                  game.per_sequence(eta, 300, dtype, cuda),
                  game.per_sequence(lengths, 300, torch.int32, cuda))
    want = game.regrets_fused_reference(zt, yt, fl, et, ln,
                                        replay=not contract)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3])
@pytest.mark.parametrize("contract", [True, False])
def test_smart_kernel_matches_plain(cuda, dtype, d, contract):
    z, y, lengths = _batch(300, 129, d, seed=10 + d, contract=contract)
    thresh = np.where(np.arange(300) % 2 == 0, 2.0, 6.5)
    zt, yt = _to((z, y), cuda, dtype)
    before = smart.LAUNCHES
    got = smart.smart_regrets(zt, yt, thresh, 1.3, lengths)
    torch.cuda.synchronize()
    assert smart.LAUNCHES == before + 1
    want = smart.smart_regrets_reference(
        zt, yt, game.per_sequence(thresh, 300, dtype, cuda),
        game.per_sequence(1.3, 300, dtype, cuda),
        game.per_sequence(lengths, 300, torch.int32, cuda),
        replay=not contract)
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= TOL[dtype]
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
@pytest.mark.parametrize("T", [200, 800])
def test_deterministic_families_match_golden_on_card(cuda, title, T):
    z, y, _ = CASES[title](run_seed=2025)(T)
    zt, yt = _to((z[None], y[None]), cuda, torch.float64)
    eta = math.sqrt(2.0)
    for flag in (0, 1):
        cum, comp, _ = game.regrets_fused(zt, yt, flag, eta)
        assert abs(float(cum - comp) - golden_simulate_alg(z, y, flag, eta)) <= 1e-9
    for thr in (math.sqrt(2.0 * T), 10.0):
        cum, comp, _, tau = smart.smart_regrets(zt, yt, thr, eta)
        want, want_tau = golden_simulate_smart(z, y, thr, eta,
                                               return_switch=True)
        assert abs(float(cum - comp) - want) <= 1e-9
        assert int(tau) == want_tau


def test_kernel_rejects_d_above_max(cuda):
    z = torch.zeros((2, 4, 513), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="d <= 512"):
        game.regrets_fused(z, torch.ones((2, 4), dtype=torch.float64,
                                         device=cuda), 0, 1.0)


def _max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3])
@pytest.mark.parametrize("contract", [True, False])
def test_eta_sweep_kernel_matches_plain(cuda, dtype, d, contract):
    z, y, lengths = _batch(200, 97, d, seed=20 + d, contract=contract)
    grid = np.array([0.05, 0.4, 1.3, 4.0])
    zt, yt = _to((z, y), cuda, dtype)
    before = game.SWEEP_LAUNCHES
    got = game.eta_sweep(zt, yt, grid, lengths)
    torch.cuda.synchronize()
    assert game.SWEEP_LAUNCHES == before + 1
    assert got.shape == (200, 4) and got.dtype == dtype
    want = game.eta_sweep_reference(
        zt, yt, torch.as_tensor(grid, dtype=dtype, device=cuda),
        game.per_sequence(lengths, 200, torch.int32, cuda),
        replay=not contract)
    assert _max_err((got,), (want,)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3])
@pytest.mark.parametrize("contract", [True, False])
def test_smart_sweep_kernel_matches_plain(cuda, dtype, d, contract):
    z, y, lengths = _batch(200, 113, d, seed=40 + d, contract=contract)
    grid = np.array([1.0, 2.5, 6.0, 1e9])
    zt, yt = _to((z, y), cuda, dtype)
    before = smart.SWEEP_LAUNCHES
    got, tau = smart.smart_sweep(zt, yt, grid, 1.3, lengths)
    torch.cuda.synchronize()
    assert smart.SWEEP_LAUNCHES == before + 1
    assert got.shape == tau.shape == (200, 4)
    want, want_tau = smart.smart_sweep_reference(
        zt, yt, torch.as_tensor(grid, dtype=dtype, device=cuda),
        torch.tensor(1.3, dtype=dtype, device=cuda),
        game.per_sequence(lengths, 200, torch.int32, cuda),
        replay=not contract)
    assert _max_err((got,), (want,)) <= TOL[dtype]
    assert torch.equal(tau, want_tau)
    assert bool((tau < 113).any()) and bool((tau[:, 3] == 113).all())


@pytest.mark.parametrize("contract", [True, False])
def test_sweep_columns_equal_k1_and_k2_on_the_cross_product(cuda, contract):
    """In f64 a sweep column is bit for bit K1 (K2) run on the repeated
    sequences with that setting."""
    z, y, lengths = _batch(64, 90, 5, seed=7, contract=contract)
    zt, yt = _to((z, y), cuda, torch.float64)
    etas = np.array([0.3, 1.0, math.sqrt(2.0), 3.1])
    reg = game.eta_sweep(zt, yt, etas, lengths)
    rep = lambda t: t.repeat_interleave(4, 0)
    ln = np.repeat(lengths, 4)
    cum, comp, _ = game.regrets_fused(rep(zt), rep(yt), 0, np.tile(etas, 64),
                                      ln)
    assert torch.equal(reg.reshape(-1), cum - comp)
    ths = np.array([1.0, 2.5, 6.0, 10.0])
    reg, tau = smart.smart_sweep(zt, yt, ths, math.sqrt(2.0), lengths)
    cum, comp, _, tau1 = smart.smart_regrets(rep(zt), rep(yt),
                                             np.tile(ths, 64),
                                             math.sqrt(2.0), ln)
    assert torch.equal(reg.reshape(-1), cum - comp)
    assert torch.equal(tau.reshape(-1), tau1)


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
@pytest.mark.parametrize("T", [200, 800])
def test_smart_sweep_families_match_golden_on_card(cuda, title, T):
    z, y, _ = CASES[title](run_seed=2025)(T)
    zt, yt = _to((z[None], y[None]), cuda, torch.float64)
    ths = [math.sqrt(2.0 * T), 10.0]
    reg, tau = smart.smart_sweep(zt, yt, ths, math.sqrt(2.0))
    for g, thr in enumerate(ths):
        want, want_tau = golden_simulate_smart(z, y, thr, math.sqrt(2.0),
                                               return_switch=True)
        assert abs(float(reg[0, g]) - want) <= 1e-9
        assert int(tau[0, g]) == want_tau


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3])
def test_stream_kernel_matches_plain(cuda, dtype, d):
    z, y, _ = _batch(200, 96, d, seed=60 + d)
    ztm = torch.as_tensor(z.transpose(1, 2, 0), dtype=dtype,
                          device=cuda).contiguous()
    ytm = torch.as_tensor(y.T, dtype=dtype, device=cuda).contiguous()
    flags = game.per_sequence(np.arange(200) % 2, 200, torch.int32, cuda)
    eta = game.per_sequence(np.linspace(0.3, 2.0, 200), 200, dtype, cuda)
    carry = ref = game.zero_stream_carry(200, d, dtype, cuda)
    before = game.STREAM_LAUNCHES
    for lo, hi in ((0, 40), (40, 41), (41, 96)):
        carry = game.play_stream(ztm[lo:hi], ytm[lo:hi], eta, lo, carry,
                                 alg_flag=flags)
        ref = game.play_stream_reference(ztm[lo:hi], ytm[lo:hi], flags, eta,
                                         lo, ref)
    torch.cuda.synchronize()
    assert game.STREAM_LAUNCHES == before + 3
    assert _max_err(carry, ref) <= TOL[dtype]
    assert _max_err(game.stream_result(carry),
                    game.stream_result(ref)) <= TOL[dtype]


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_stream_chunked_equals_one_k1_launch(cuda, alg_flag):
    """Fed in chunks through K4 in f64, the regret is bit for bit one K1
    launch over the whole sequences."""
    z, y, _ = _batch(300, 130, 5, seed=70 + alg_flag)
    kg = StreamingKernelGame(300, 5, alg_flag=alg_flag, eta0=1.3,
                             dtype=torch.float64, device=cuda, validate=True)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    for lo, hi in ((0, 64), (64, 65), (65, 130)):
        kg.feed(ztm[lo:hi], ytm[lo:hi])
    got = kg.result()
    zt, yt = _to((z, y), cuda, torch.float64)
    cum, comp, _ = game.regrets_fused(zt, yt, alg_flag, 1.3)
    assert torch.equal(got.cum_loss, cum)
    assert torch.equal(got.comp_loss, comp)
    assert torch.equal(got.regret, cum - comp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3, 96])
def test_packed_kernels_match_plain_and_k1(cuda, dtype, d):
    """K3 (both flags) and K3e against their plain versions; their cum
    against K1's bit for bit."""
    z, y, _ = _batch(300, 90, d, seed=80 + d)
    zt, yt = _to((z, y), cuda, dtype)
    z_tm, y_tm = game.time_major(zt, yt)
    scales = game.ftrl_scales(90, 1.3, dtype=dtype, device=cuda)
    etas = torch.linspace(0.05, 4.0, 300, dtype=dtype, device=cuda)
    before = (game.PACKED_LAUNCHES, game.PACKED_ETA_LAUNCHES)
    for flag in (0, 1):
        got = game.play_packed(z_tm, y_tm, scales, alg_flag=flag)
        want = game.play_packed_reference(z_tm, y_tm, scales, flag)
        assert _max_err(got, want) <= TOL[dtype]
        assert torch.equal(got[0], game.regrets_fused(zt, yt, flag, 1.3)[0])
    got = game.play_packed_eta(z_tm, y_tm, etas)
    assert _max_err(got, game.play_packed_eta_reference(z_tm, y_tm, etas)
                    ) <= TOL[dtype]
    assert torch.equal(got[0], game.regrets_fused(zt, yt, 0, etas)[0])
    torch.cuda.synchronize()
    assert (game.PACKED_LAUNCHES, game.PACKED_ETA_LAUNCHES) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_large_d_instances_match_plain(cuda, dtype):
    """K1 and K2 at d = 256 (the large-d instance) and d = 512, the limit."""
    for d in (256, 512):
        z, y, lengths = _batch(64, 24, d, seed=d)
        zt, yt = _to((z, y), cuda, dtype)
        ln = game.per_sequence(lengths, 64, torch.int32, cuda)
        fl = game.per_sequence(np.arange(64) % 2, 64, torch.int32, cuda)
        et = game.per_sequence(1.3, 64, dtype, cuda)
        assert _max_err(game.regrets_fused(zt, yt, fl, et, ln),
                        game.regrets_fused_reference(zt, yt, fl, et, ln)
                        ) <= TOL[dtype]
        th = game.per_sequence(2.0, 64, dtype, cuda)
        got = smart.smart_regrets(zt, yt, th, et, ln)
        want = smart.smart_regrets_reference(zt, yt, th, et, ln)
        assert _max_err(got[:3], want[:3]) <= TOL[dtype]
        assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 3])
def test_quadratic_kernels_match_plain(cuda, dtype, d):
    """K8 (mixed flags) and K9 against their plain versions; K8's x_c is K9
    on the final statistics bit for bit."""
    rng = np.random.default_rng(90 + d)
    B, T = 200, 120
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = z @ (np.ones(d) / np.sqrt(d)) + 0.2 * rng.normal(size=(B, T))
    zt, yt = _to((z, y), cuda, dtype)
    z_tm, y_tm = game.time_major(zt, yt)
    flags = game.per_sequence(np.arange(B) % 2, B, torch.int32, cuda)
    eta = game.per_sequence(np.linspace(0.5, 2.0, B), B, dtype, cuda)
    before = trs.QUAD_LAUNCHES
    got = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
    want = trs.quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    assert _max_err(got, want) <= TOL[dtype]
    A = torch.zeros((B, d, d), dtype=dtype, device=cuda)
    b = torch.zeros((B, d), dtype=dtype, device=cuda)
    for t in range(T):
        A = A + zt[:, t, :, None] * zt[:, t, None, :]
        b = b + yt[:, t, None] * zt[:, t]
    x9 = trs.trs_solve(A, b)
    assert _max_err((x9,), (trs.trs_solve_reference(A, b),)) <= TOL[dtype]
    torch.cuda.synchronize()
    assert trs.QUAD_LAUNCHES == before + 1
    if dtype == torch.float64:
        assert torch.equal(got[2], x9.t())


def test_quadratic_study_cuda_equals_cpu(cuda):
    kw = dict(runs=2, replicates=2, dtype=np.float64)
    got = evaluate_quadratic_stream((100, 200), device=cuda, **kw)
    want = evaluate_quadratic_stream((100, 200), device="cpu", **kw)
    for k in got:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("d", [5, 3, 130])
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_synthetic_kernel_matches_plain_and_k1(cuda, d, alg_flag):
    """K7 against its plain version on the card, bit for bit, and against
    K1 on synthetic_stream's materialized rows, bit for bit; a larger
    lane_batch extends the same population."""
    before = game.SYNTHETIC_LAUNCHES
    got = game.synthetic_regrets(3 << 20, 1.3, T=200, lane_batch=32, d=d,
                                 alg_flag=alg_flag)
    torch.cuda.synchronize()
    assert game.SYNTHETIC_LAUNCHES == before + 1
    assert got.shape == (8, 32) and got.device.type == "cuda"
    want = game.synthetic_regrets_reference(3 << 20, 1.3, T=200,
                                            lane_batch=32, d=d,
                                            alg_flag=alg_flag, device=cuda)
    assert torch.equal(got, want)
    z, y = game.synthetic_stream(3 << 20, T=200, lane_batch=32, d=d,
                                 device=cuda)
    cum, comp, _ = game.regrets_fused(z, y, alg_flag, 1.3)
    assert torch.equal(got.reshape(-1), cum - comp)
    wider = game.synthetic_regrets(3 << 20, 1.3, T=200, lane_batch=64, d=d,
                                   alg_flag=alg_flag)
    assert torch.equal(wider.reshape(-1)[:256], got.reshape(-1))


def test_synthetic_kernel_rejects_d_above_max(cuda):
    with pytest.raises(ValueError, match="d <= 512"):
        game.synthetic_regrets(0, 1.0, T=4, lane_batch=1, d=513)
    out = game.synthetic_regrets(0, 1.0, T=4, lane_batch=1, d=512)
    assert bool(torch.isfinite(out).all())
