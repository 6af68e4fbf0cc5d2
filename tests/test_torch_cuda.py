"""Kernels K1-K10 on the card against their plain PyTorch versions; the
sweeps, the stream, the packed game (K3, K3e) and the generation-fused
game (K7) against K1 and K2; K8's comparator against K9; the quadratic
study and the exact track's kernel route against their CPU runs.

Needs a CUDA device and nvcc; skipped elsewhere.  This file imports only
torch, numpy and the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.data import device as device_data
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.experiments.quadratic_study import (
    evaluate_quadratic_stream,
)
from online_convex_optimization_tpu_torch.ops import admm, game, smart, trs
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,contract", [(5, True), (3, True), (65, True),
                                        (5, False)])
def test_plays_kernels_equal_plain_bit_for_bit(cuda, dtype, d, contract):
    """The evaluation's entries: K1 with two plays a sequence and K2 with
    two and four thresholds a sequence, one launch each, equal their plain
    versions on the card in every bit."""
    z, y, lengths = _batch(300, 129, d, seed=30 + d, contract=contract)
    zt, yt = _to((z, y), cuda, dtype)
    ln = game.per_sequence(lengths, 300, torch.int32, cuda)
    replay = not game.in_contract(zt, yt, ln)
    before = game.LAUNCHES
    got = game.regret_plays(zt, yt, (0, 1), 1.3, ln, replay)
    torch.cuda.synchronize()
    assert game.LAUNCHES == before + 1
    flags = torch.tensor([[0] * 300, [1] * 300], dtype=torch.int32,
                         device=cuda)
    eta = game.per_sequence(1.3, 300, dtype, cuda)
    want = game.regret_plays_reference(zt, yt, flags, eta, ln, replay=replay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for G in (2, 4):
        ths = torch.stack([torch.full((300,), 0.5 + 2 * g, dtype=dtype,
                                      device=cuda) for g in range(G - 1)]
                          + [torch.sqrt(2.0 * ln.to(dtype))])
        before = smart.LAUNCHES
        got = smart.smart_plays(zt, yt, ths, 1.3, ln, replay)
        torch.cuda.synchronize()
        assert smart.LAUNCHES == before + 1
        want = smart.smart_plays_reference(zt, yt, ths, eta, ln,
                                           replay=replay)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_main_path_launches_once_a_case(cuda):
    """The g(T) table is one K1 launch; a case is one K1 and one K2
    launch."""
    from online_convex_optimization_tpu_torch.experiments.evaluate import (
        evaluate_stream_with_stats)
    from online_convex_optimization_tpu_torch.experiments.gt import (
        estimate_g)
    k1, k2 = game.LAUNCHES, smart.LAUNCHES
    g = estimate_g((40, 80), runs=20, progress=False, device="cuda")
    assert (game.LAUNCHES, smart.LAUNCHES) == (k1 + 1, k2)
    evaluate_stream_with_stats(CASES["Massart noise 10%"], (40, 80), g,
                               runs=3, replicates=4, progress=False,
                               device="cuda")
    assert (game.LAUNCHES, smart.LAUNCHES) == (k1 + 2, k2 + 1)


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


# Thresholds unsorted, with a duplicate, one that never fires and one that
# fires at round 0; 13 of them and 11 etas: neither a multiple of the
# 8 settings a K5 or K6b block serves.
SWEEP_ETAS = np.array([0.05, 0.2, 0.4, 0.7, 1.0, 1.3, math.sqrt(2.0), 2.0,
                       2.6, 3.3, 4.0])
SWEEP_THS = np.array([6.0, 1.0, 1e9, 2.5, -1e9, 2.5, 0.7, 10.0, 3.7, 1.8,
                      4.4, 0.2, 14.0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [3, 5, 64, 65])
@pytest.mark.parametrize("contract", [True, False])
def test_redesigned_sweeps_match_plain_at_ragged_shapes(cuda, dtype, d,
                                                       contract):
    """K5, K6a and K6b at B = 77 (not a multiple of 32), T = 203 (no
    multiple of the staged chunk but 1), every kernel instance (d = 5, the
    generic d <= 64, the large d), against their plain versions, K6a and K6b
    each against its part of the split mirror; f64 bit for bit."""
    z, y, lengths = _batch(77, 203, d, seed=60 + d, contract=contract)
    zt, yt = _to((z, y), cuda, dtype)
    lt = game.per_sequence(lengths, 77, torch.int32, cuda)
    grid = torch.as_tensor(SWEEP_ETAS, dtype=dtype, device=cuda)
    ths = torch.as_tensor(SWEEP_THS, dtype=dtype, device=cuda)
    eta = torch.tensor(1.3, dtype=dtype, device=cuda)
    counts = (game.SWEEP_LAUNCHES, smart.SWEEP_LAUNCHES,
              smart.SWEEP_TAIL_LAUNCHES)
    got5 = game.eta_sweep(zt, yt, grid, lengths)
    got6, tau = smart.smart_sweep(zt, yt, ths, 1.3, lengths)
    torch.cuda.synchronize()
    assert (game.SWEEP_LAUNCHES, smart.SWEEP_LAUNCHES,
            smart.SWEEP_TAIL_LAUNCHES) == tuple(c + 1 for c in counts)
    want5 = game.eta_sweep_reference(zt, yt, grid, lt, replay=not contract)
    want6, want_tau = smart.smart_sweep_reference(zt, yt, ths, eta, lt,
                                                  replay=not contract)
    assert torch.equal(tau, want_tau)
    assert bool((tau[:, 2] == 203).all()) and bool((tau[:, 4] < 203).any())
    order = game.length_order(lt)
    ordered, perm = torch.sort(ths, stable=True)
    perm = perm.to(torch.int32)
    part, tau_a, comp = smart.launch_smart_prefix(
        zt, yt, ordered, perm, order, lt, not contract)
    want_part, _, want_comp = smart.smart_prefix_reference(
        zt, yt, ths, lt, replay=not contract)
    assert torch.equal(tau_a.t(), want_tau)
    scales = game.sweep_scales(eta.reshape(1), 203)
    tails = part.clone()
    smart.launch_smart_tails(zt, yt, scales, order, lt, tau_a, comp, tails)
    want_tails = smart.smart_tails_reference(zt, yt, scales[0], lt, want_tau,
                                             want_part, want_comp)
    pairs = ((got5, want5), (got6, want6), (part.t(), want_part),
             (comp, want_comp), (tails.t(), want_tails))
    if dtype == torch.float64:
        assert all(torch.equal(g, w) for g, w in pairs)
    else:
        assert _max_err(*zip(*pairs)) <= TOL[dtype]


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
@pytest.mark.parametrize("CT", [1, 7, 1000])
def test_stream_ragged_chunks_equal_one_k1_launch(cuda, dtype, CT):
    """B = 1000 (not a multiple of the block width), T = 1000 fed in chunks
    of CT rounds (CT = 7 leaves a chunk of 6; CT = 1 is shorter than the
    load pipeline): the regret equals one K1 launch bit for bit and the
    carry its plain version's."""
    B, T = 1000, 1000
    z, y, _ = _batch(B, T, 5, seed=80 + CT)
    ztm = torch.as_tensor(z.transpose(1, 2, 0), dtype=dtype,
                          device=cuda).contiguous()
    ytm = torch.as_tensor(y.T, dtype=dtype, device=cuda).contiguous()
    flags = game.per_sequence(np.arange(B) % 2, B, torch.int32, cuda)
    eta = game.per_sequence(1.3, B, dtype, cuda)
    carry = ref = game.zero_stream_carry(B, 5, dtype, cuda)
    for lo in range(0, T, CT):
        hi = min(lo + CT, T)
        carry = game.play_stream(ztm[lo:hi], ytm[lo:hi], 1.3, lo, carry,
                                 alg_flag=flags)
        ref = game.play_stream_reference(ztm[lo:hi], ytm[lo:hi], flags, eta,
                                         lo, ref)
    regret, cum_s, comp_s = game.stream_result(carry)
    zt, yt = _to((z, y), cuda, dtype)
    cum, comp, _ = game.regrets_fused(zt, yt, flags, 1.3)
    assert torch.equal(cum_s, cum) and torch.equal(comp_s, comp)
    assert torch.equal(regret, cum - comp)
    assert _max_err(carry, ref) <= TOL[dtype]


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 5, 7, 32])
@pytest.mark.parametrize("N", [1, 31, 33, 4103])
def test_trs_kernel_refill_matches_plain(cuda, dtype, d, N):
    """K9's refilling lanes give trs_solve_reference's bits on every
    prefix of regression streams (the t = 0 problem and the singular
    prefixes first); a permuted batch gives the permuted output; K8's x_c
    is K9 on the final statistics."""
    rng = np.random.default_rng(N + d)
    B, T = 8, max(1, -(-N // 8))
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = z @ (np.ones(d) / np.sqrt(d)) + 0.1 * rng.normal(size=(B, T))
    zt, yt = _to((z, y), cuda, dtype)
    A_pre = torch.zeros((T, B, d, d), dtype=dtype, device=cuda)
    b_pre = torch.zeros((T, B, d), dtype=dtype, device=cuda)
    A = torch.zeros((B, d, d), dtype=dtype, device=cuda)
    b = torch.zeros((B, d), dtype=dtype, device=cuda)
    for t in range(T):
        A_pre[t], b_pre[t] = A, b
        A = A + zt[:, t, :, None] * zt[:, t, None, :]
        b = b + yt[:, t, None] * zt[:, t]
    A_all, b_all = A_pre.reshape(-1, d, d)[:N], b_pre.reshape(-1, d)[:N]
    before = trs.TRS_LAUNCHES
    got = trs.trs_solve(A_all, b_all)
    torch.cuda.synchronize()
    assert trs.TRS_LAUNCHES == before + 1
    assert torch.equal(got, trs.trs_solve_reference(A_all, b_all))
    perm = torch.as_tensor(rng.permutation(N), device=cuda)
    assert torch.equal(trs.trs_solve(A_all[perm], b_all[perm]), got[perm])
    z_tm, y_tm = game.time_major(zt, yt)
    ftl = torch.ones(B, dtype=torch.int32, device=cuda)
    x_c = trs.quadratic_regrets(z_tm, y_tm, ftl, 1.0)[2]
    assert torch.equal(x_c, trs.trs_solve(A, b).t())


def test_quadratic_study_cuda_equals_cpu(cuda):
    kw = dict(runs=2, replicates=2, dtype=np.float64)
    got = evaluate_quadratic_stream((100, 200), device=cuda, **kw)
    want = evaluate_quadratic_stream((100, 200), device="cpu", **kw)
    for k in got:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 7, 32])
@pytest.mark.parametrize("pattern", ["interleaved", "blocks"])
def test_quadratic_kernel_lanes_match_plain(cuda, dtype, d, pattern):
    """K8's per-lane rounds at an odd B with interleaved or blocked flags:
    within the bound of its plain version; x_c equal to K9 on the final
    statistics in every bit; the same sequences in another order, or
    32, 3 or 1 FTL sequences a warp, give the same bits (each lane plays
    its own sequence)."""
    rng = np.random.default_rng(7 * d)
    B, T = 77, 60
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = z @ (np.ones(d) / np.sqrt(d)) + 0.1 * rng.normal(size=(B, T))
    zt, yt = _to((z, y), cuda, dtype)
    z_tm, y_tm = game.time_major(zt, yt)
    f = np.arange(B) % 2 if pattern == "interleaved" else np.arange(B) >= 30
    flags = game.per_sequence(f, B, torch.int32, cuda)
    eta = game.per_sequence(np.linspace(0.5, 2.0, B), B, dtype, cuda)
    got = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
    want = trs.quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    assert _max_err(got, want) <= TOL[dtype]
    A = torch.zeros((B, d, d), dtype=dtype, device=cuda)
    b = torch.zeros((B, d), dtype=dtype, device=cuda)
    for t in range(T):
        A = A + zt[:, t, :, None] * zt[:, t, None, :]
        b = b + yt[:, t, None] * zt[:, t]
    assert torch.equal(got[2], trs.trs_solve(A, b).t())
    perm = torch.as_tensor(rng.permutation(B), device=cuda)
    again = trs.quadratic_regrets(z_tm[..., perm].contiguous(),
                                  y_tm[:, perm].contiguous(), flags[perm],
                                  eta[perm])
    for a, g in zip(again, got):
        assert torch.equal(a, g[..., perm])
    for width in (32, 3, 1):
        wide = trs.launch_quadratic_regrets(z_tm, y_tm, flags, eta, width)
        assert all(torch.equal(a, g) for a, g in zip(wide, got))


@pytest.mark.parametrize("T", [1, 1023, 1024, 2500])
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_synthetic_kernel_scale_table_chunks(cuda, T, alg_flag):
    """K7 bit for bit its plain version where T ends inside, at and past a
    chunk of the FTRL scale table, with a block partly past B."""
    got = game.synthetic_regrets(5, 0.7, T=T, lane_batch=20,
                                 alg_flag=alg_flag)
    want = game.synthetic_regrets_reference(5, 0.7, T=T, lane_batch=20,
                                            alg_flag=alg_flag, device=cuda)
    assert torch.equal(got, want)


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


# ---------------------------------------------------------------- K10

def _admm_batch(B, T, d, seed, cuda):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    u = rng.normal(size=(B, d))
    y = np.sign(np.einsum("btd,bd->bt", z, u) + 0.3 * rng.normal(size=(B, T)))
    return _to((z, y), cuda, torch.float32)


@pytest.mark.parametrize("B,T,d", [(2, 70, 5), (2, 1000, 5), (3, 300, 3),
                                   (2, 500, 8), (1, 1100, 5), (1, 4096, 5),
                                   (1, 2500, 8)])
def test_admm_kernel_matches_plain_fixed_iterations(cuda, B, T, d):
    """K10 against its plain version on the same factor: 300 fixed
    iterations, state and residuals within the f32 bound."""
    z, y = _admm_batch(B, T, d, seed=T + d, cuda=cuda)
    before = admm.LAUNCHES
    X, res, state = admm.admm_all_prefixes_l2(z, y, iters=300, tol=0.0)
    torch.cuda.synchronize()
    # Past T = 2048 the rows of 16 entries a lane take a launch of their own.
    assert admm.LAUNCHES == before + (2 if T > 2048 else 1)
    res_p, state_p = admm.admm_all_prefixes_l2_reference(
        z, y, admm.admm_prologue(z), iters=300, tol=0.0, check_every=100,
        rho=1.0, alpha=1.7)
    assert _max_err(state, state_p) <= TOL[torch.float32]
    assert _max_err((res.reshape(-1),), (res_p,)) <= TOL[torch.float32]
    assert torch.equal(X, state[3].reshape(B, T, d))


@pytest.mark.parametrize("T", [400, 1100])
def test_admm_kernel_continuation_and_subset_are_bit_for_bit(cuda, T):
    """At T = 1100 the long rows span several warps."""
    z, y = _admm_batch(3, T, 5, seed=1, cuda=cuda)
    _, _, st = admm.admm_all_prefixes_l2(z, y, iters=100, tol=0.0)
    Xc, rc, stc = admm.admm_all_prefixes_l2(z, y, iters=150, tol=0.0,
                                            state0=st)
    Xl, rl, stl = admm.admm_all_prefixes_l2(z, y, iters=250, tol=0.0)
    assert torch.equal(Xc, Xl) and torch.equal(rc, rl)
    assert all(torch.equal(a, b) for a, b in zip(stc, stl))
    X, res, _ = admm.admm_all_prefixes_l2(z, y, iters=6000, tol=2e-4)
    X1, res1, _ = admm.admm_all_prefixes_l2(z[1:2].contiguous(),
                                            y[1:2].contiguous(), iters=6000,
                                            tol=2e-4)
    assert torch.equal(X[1], X1[0]) and torch.equal(res[1], res1[0])
    assert float(res.max()) <= 2e-4


def test_admm_kernel_polished_objectives_match_plain_route(cuda):
    """At the route's tol, after the host polish (both scaled into the ball
    first), every 10th prefix's objective within 3e-6 above the plain
    banded ADMM's (the on-chip bar of the JAX package's
    tests/test_pallas_admm.py)."""
    from online_convex_optimization_tpu_torch.models.exact_ftl import (
        _admm_all_prefixes)
    from online_convex_optimization_tpu_torch.models.polish import (
        objective, polish_prefix_actions)
    z, y = _admm_batch(2, 300, 5, seed=7, cuda=cuda)
    X, res, _ = admm.admm_all_prefixes_l2(z, y, iters=6000, tol=2e-4)
    assert float(res.max()) <= 1e-3
    Xx, _, _ = _admm_all_prefixes(z, y, iters=6000, tol=2e-4)
    zh, yh = z.double().cpu().numpy(), y.double().cpu().numpy()
    for b in range(2):
        acts = [polish_prefix_actions(zh[b], yh[b], np.concatenate(
            [np.zeros((1, 5)), admm.feasible_actions(a)[b]]), "l2")
            for a in (X, Xx)]
        for p in range(10, 301, 10):
            fk, fx = (objective(zh[b][:p], yh[b][:p], a[p]) for a in acts)
            assert fk <= fx + 3e-6, (b, p)


@pytest.mark.parametrize("T,T_max,tol", [(600, 1000, 0.0),
                                         (600, 1000, 2e-4),
                                         (2100, 2600, 0.0)])
def test_admm_kernel_sliced_equals_padded(cuda, T, T_max, tol):
    """The kernel route's launch on z[:, :T] equals rows p < T of the
    launch on z zero-padded to T_max, bit for bit (a row's split across
    warps depends on its own length only)."""
    z, y = _admm_batch(2, T_max, 5, seed=T, cuda=cuda)
    z[:, T:] = 0.0
    y[:, T:] = 0.0
    kw = dict(iters=300 if tol == 0.0 else 6000, tol=tol)
    X, res, st = admm.admm_all_prefixes_l2(z[:, :T].contiguous(),
                                           y[:, :T].contiguous(), **kw)
    Xp, resp, stp = admm.admm_all_prefixes_l2(z, y, **kw)
    assert torch.equal(X, Xp[:, :T]) and torch.equal(res, resp[:, :T])
    for a, ap in zip(st, stp):
        ap = ap.reshape(2, T_max, -1)[:, :T]
        if a.shape[-1] == T:          # s, u: entries past T are 0 in both
            assert bool((ap[..., T:] == 0).all())
            ap = ap[..., :T]
        assert torch.equal(a.reshape(2, T, -1), ap)


def test_admm_kernel_refuses_its_envelope(cuda):
    """d <= 8 is K10's envelope; any T has an instance (T = 4,097: K10l
    takes its one long row)."""
    z, y = _admm_batch(1, 4097, 5, seed=2, cuda=cuda)
    before = admm.LONG_LAUNCHES
    X, res, _ = admm.admm_all_prefixes_l2(z, y, iters=20, tol=0.0)
    torch.cuda.synchronize()
    assert admm.LONG_LAUNCHES == before + 1
    assert bool(torch.isfinite(X).all()) and bool(torch.isfinite(res).all())
    z, y = _admm_batch(1, 20, 9, seed=2, cuda=cuda)
    with pytest.raises(ValueError, match="d <= 8"):
        admm.admm_all_prefixes_l2(z, y)
    with pytest.raises(TypeError, match="float32"):
        admm.admm_all_prefixes_l2(z.double(), y.double())


def test_exact_kernel_route_on_the_card(cuda):
    """evaluate_stream_exact(solver='kernel') on the card: one K10 launch a
    cell (no escalation here), and the same statistics as the route's CPU
    run within the f32 bound."""
    from online_convex_optimization_tpu_torch.experiments.evaluate import (
        evaluate_stream_exact)
    kw = dict(T_grid=[60, 120], runs=2, replicates=3, dtype=np.float32,
              solver="kernel", progress=False)
    audit = {}
    before = admm.LAUNCHES
    got = evaluate_stream_exact(CASES["Massart noise 10%"], audit_out=audit,
                                device=cuda, **kw)
    assert audit["cells_kernel"] == 4 and audit["replicates_escalated"] == 0
    assert admm.LAUNCHES == before + 4
    want = evaluate_stream_exact(CASES["Massart noise 10%"], device="cpu",
                                 **kw)
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL[torch.float32])


# The most the actions of the prefixes shorter than d may move the
# pipeline's exact-FTL regret between the card and the CPU: four times the
# largest move under a one-ulp change of the SSN's input on the CPU
# (1.2e-7, scripts/ssn_ulp_study.py).
SHORT_PREFIX_SLACK = 5e-7


def test_ssn_on_the_card_matches_cpu(cuda, monkeypatch):
    """The semismooth Newton (plain PyTorch, float64) on the card against
    its CPU run: at a fixed 10 steps X, mu and the objective within 1e-9
    on the prefixes of at least d rows (shorter ones interpolate on a
    continuum, where the iterate and its objective are rounding-determined:
    on this instance a one-ulp change of z moves the CPU run's 3-row
    objective by 2.4e-9, ``scripts/ssn_ulp_study.py``); the steps replayed
    from one CUDA graph equal the eager steps in every bit; converged at
    tol 2e-4 on both, where every prefix's objective, the short ones
    included, agrees within the larger certified gap res (1 + f); the
    pipeline's "ssn" route through K1: FTRL within
    1e-9 of its CPU run, exact FTL's polished actions within 1e-9 on the
    prefixes of at least d rows, and its regret within 1e-9 plus what the
    shorter prefixes' actions can move it: the sum over them of 0.5
    |<x_card - x_cpu, z_p>| for the row p each is played on, itself at
    most SHORT_PREFIX_SLACK (a one-ulp change of the SSN's input moves the
    regret by up to 1.2e-7 on the CPU), so that a wrong set of short-prefix
    actions still fails.  Both converged runs need more than 200 steps:
    member 0 takes 274 on the CPU, as JAX's SSN does on it."""
    from online_convex_optimization_tpu_torch.experiments.evaluate import (
        evaluate_stream_exact)
    from online_convex_optimization_tpu_torch.models import polish, ssn
    rng = np.random.default_rng(0)
    B, T, d = 2, 60, 5
    z = 2.0 * rng.normal(size=(B, T, d))
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(B, d)))
                + 0.3 * rng.normal(size=(B, T)))
    zc, yc = (torch.from_numpy(a) for a in (z, y))
    Xg, _, (_, mug) = ssn.ssn_all_prefixes(zc.to(cuda), yc.to(cuda),
                                           iters=10, tol=0.0)
    monkeypatch.setattr(ssn, "_CUDA_GRAPHS", False)
    Xe, _, (_, mue) = ssn.ssn_all_prefixes(zc.to(cuda), yc.to(cuda),
                                           iters=10, tol=0.0)
    monkeypatch.undo()
    assert torch.equal(Xg, Xe) and torch.equal(mug, mue)
    Xc, _, (_, muc) = ssn.ssn_all_prefixes(zc, yc, iters=10, tol=0.0)
    Xg, mug = Xg.cpu().numpy(), mug.cpu().numpy()
    np.testing.assert_allclose(Xg[:, d - 1:], Xc.numpy()[:, d - 1:],
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(mug[:, d - 1:], muc.numpy()[:, d - 1:],
                               atol=1e-9, rtol=0)
    m = np.tril(np.ones((T, T)))
    f = lambda X: 0.5 * (np.abs(np.einsum("btd,bpd->bpt", z, X)
                                - y[:, None]) * m).sum(-1)
    fg, fc = f(Xg), f(Xc.numpy())
    assert (np.abs(fg - fc)[:, d - 1:] <= 1e-9 * (1 + fc)[:, d - 1:]).all()
    solved = {}
    for dev in (cuda, "cpu"):
        X, res, _ = ssn.ssn_all_prefixes(zc.to(dev), yc.to(dev), iters=400,
                                         tol=2e-4)
        assert float(res.max()) <= 2e-4
        X, res = X.cpu().numpy(), res.cpu().numpy()
        solved[dev] = (f(X), res)
    (fg, rg), (fc, rc) = solved[cuda], solved["cpu"]
    # res = min(f - D, f) / (1 + f) >= (f - f*) / (1 + f) on both runs; f
    # itself is a float64 sum of T terms (1e-12 (1 + f) for its rounding).
    bound = np.maximum(rg * (1 + fg), rc * (1 + fc)) + 1e-12 * (1 + fc)
    assert (np.abs(fg - fc) <= bound).all(), np.argwhere(
        np.abs(fg - fc) > bound)
    kw = dict(T_grid=[40, 60], runs=1, replicates=2, solver="ssn",
              progress=False)
    keep, kept = polish.polish_prefix_actions, []

    def keeping(z, y, acts, *args, **kwargs):
        out = keep(z, y, acts, *args, **kwargs)
        kept.append((np.array(z, np.float64), out[:max(kwargs["lengths"])
                                                 + 1]))
        return out
    monkeypatch.setattr(polish, "polish_prefix_actions", keeping)
    before = game.LAUNCHES
    got = evaluate_stream_exact(CASES["Random i.i.d. (separable)"],
                                device=cuda, **kw)
    assert game.LAUNCHES > before
    n_card = len(kept)
    want = evaluate_stream_exact(CASES["Random i.i.d. (separable)"],
                                 device="cpu", **kw)
    assert n_card > 0 and len(kept) == 2 * n_card
    slack = 0.0
    for (zg, ag), (zc, ac) in zip(kept[:n_card], kept[n_card:]):
        assert np.array_equal(zg, zc)
        # Action p (the prefix of p rows; row 0 the zero action) is played
        # on row p, where its loss 0.5 |<x, z_p> - y_p| moves by at most
        # 0.5 |<x_card - x_cpu, z_p>|.
        np.testing.assert_allclose(ag[d:], ac[d:], rtol=0, atol=1e-9)
        slack += 0.5 * float(np.abs(((ag[1:d] - ac[1:d]) * zg[1:d])
                                    .sum(-1)).sum())
    assert slack <= SHORT_PREFIX_SLACK, slack
    np.testing.assert_allclose(got["FTRL"][0], want["FTRL"][0], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["FTL (exact)"][0], want["FTL (exact)"][0],
                               rtol=0, atol=1e-9 + slack)


# ------------------------------------------- narrow storage (bf16 z, int8 y)

STORAGE_PAIRS = [(torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.int8), (torch.float32, torch.int8)]


def _stored(z, y, pair, device):
    """Rows deflated as the bf16 generators deflate them, labels +-1, stored
    in ``pair``; and the upcast float32 values."""
    zs = torch.as_tensor(z * (1.0 - 2.0 ** -8), dtype=torch.float32,
                         device=device).to(pair[0])
    ys = torch.as_tensor(np.sign(y) + (y == 0), dtype=torch.float32,
                         device=device).to(pair[1])
    return zs, ys, zs.float(), ys.float()


@pytest.mark.parametrize("pair", STORAGE_PAIRS)
@pytest.mark.parametrize("d,contract", [(5, True), (5, False), (3, True),
                                        (65, True)])
def test_storage_pairs_equal_the_f32_instance(cuda, pair, d, contract):
    """Every narrow instance of K1-K6 equals the float32 instance on the
    upcast values in every bit and its plain version within 5e-4."""
    z, y, lengths = _batch(150, 77, d, seed=90 + d)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    zs, ys, zf, yf = _stored(z, y, pair, cuda)
    ln = game.per_sequence(lengths, 150, torch.int32, cuda)
    fl = game.per_sequence(np.arange(150) % 2, 150, torch.int32, cuda)
    et = torch.linspace(0.3, 2.5, 150, device=cuda)
    th = torch.linspace(0.5, 6.0, 150, device=cuda)
    z_tm, y_tm = game.time_major(zs, ys)
    zf_tm, yf_tm = game.time_major(zf, yf)
    sc = game.ftrl_scales(77, 1.3, device=cuda)
    c0 = game.zero_stream_carry(150, d, device=cuda)
    grid = [0.5, 1.3, 2.0]
    cases = [
        (lambda a, b: game.regrets_fused(a, b, fl, et, ln),
         lambda: game.regrets_fused_reference(zf, yf, fl, et, ln,
                                              replay=not contract)),
        (lambda a, b: smart.smart_regrets(a, b, th, 1.2, ln),
         lambda: smart.smart_regrets_reference(
             zf, yf, th, torch.full((150,), 1.2, device=cuda), ln,
             replay=not contract)),
        (lambda a, b: (game.eta_sweep(a, b, grid, ln),),
         lambda: (game.eta_sweep_reference(
             zf, yf, torch.tensor(grid, device=cuda), ln,
             replay=not contract),)),
        (lambda a, b: smart.smart_sweep(a, b, grid, 1.2, ln),
         lambda: smart.smart_sweep_reference(
             zf, yf, torch.tensor(grid, device=cuda),
             torch.tensor(1.2, device=cuda), ln, replay=not contract)),
        (lambda a, b: game.play_packed(*game.time_major(a, b), sc),
         lambda: game.play_packed_reference(zf_tm, yf_tm, sc, 0)),
        (lambda a, b: game.play_packed_eta(*game.time_major(a, b), et),
         lambda: game.play_packed_eta_reference(zf_tm, yf_tm, et)),
        (lambda a, b: game.play_stream(*game.time_major(a, b), et, 9, c0,
                                       alg_flag=fl),
         lambda: game.play_stream_reference(zf_tm, yf_tm, fl, et, 9, c0)),
    ]
    before = (game.LAUNCHES, smart.LAUNCHES, game.SWEEP_LAUNCHES,
              smart.SWEEP_LAUNCHES, smart.SWEEP_TAIL_LAUNCHES,
              game.PACKED_LAUNCHES, game.PACKED_ETA_LAUNCHES,
              game.STREAM_LAUNCHES)
    for narrow, plain in cases:
        got, wide, want = narrow(zs, ys), narrow(zf, yf), plain()
        for a, b, c in zip(got, wide, want):
            assert torch.equal(a, b)
            if a.is_floating_point():
                assert a.dtype == torch.float32
                assert _max_err((a,), (c,)) <= TOL[torch.float32]
            else:
                assert torch.equal(a, c.to(a.dtype))
    torch.cuda.synchronize()
    after = (game.LAUNCHES, smart.LAUNCHES, game.SWEEP_LAUNCHES,
             smart.SWEEP_LAUNCHES, smart.SWEEP_TAIL_LAUNCHES,
             game.PACKED_LAUNCHES, game.PACKED_ETA_LAUNCHES,
             game.STREAM_LAUNCHES)
    assert all(a >= b + 2 for a, b in zip(after, before))


@pytest.mark.parametrize("pair", STORAGE_PAIRS)
def test_storage_stream_game_and_no_upcast(cuda, pair):
    """StreamingKernelGame(dtype, y_dtype) on the card equals the float32
    game on the upcast chunks; a K3 call on narrow storage allocates no
    float32 copy of z."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    z_tm, y_tm = device_data.random_time_major_batch(
        gen, 96, 2048, 5, dtype=pair[0], y_dtype=pair[1])
    a = StreamingKernelGame(2048, 5, eta0=1.2, dtype=pair[0],
                            y_dtype=pair[1], device=cuda, validate=True)
    b = StreamingKernelGame(2048, 5, eta0=1.2, device=cuda)
    for c in range(0, 96, 32):
        a.feed_packed(z_tm[c:c + 32], y_tm[c:c + 32])
        b.feed_packed(z_tm[c:c + 32].float(), y_tm[c:c + 32].float())
    assert torch.equal(a.result().regret, b.result().regret)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, launches = torch.cuda.memory_allocated(), game.PACKED_LAUNCHES
    game.play_packed(z_tm, y_tm, game.ftrl_scales(96, 1.2, device=cuda))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < z_tm.numel() * 4
    assert game.PACKED_LAUNCHES == launches + 1


# ---------------------------------------- K10l, K9w, K8w: the size gaps

@pytest.mark.parametrize("d", [5, 3])
def test_admm_long_rows_match_plain(cuda, d):
    """K10l (rows past 4,096 entries) against the plain version, 100 fixed
    iterations at T = 4,200; three launches, the long rows first."""
    z, y = _admm_batch(1, 4200, d, seed=40 + d, cuda=cuda)
    before, before_long = admm.LAUNCHES, admm.LONG_LAUNCHES
    X, res, state = admm.admm_all_prefixes_l2(z, y, iters=100, tol=0.0)
    torch.cuda.synchronize()
    assert admm.LAUNCHES == before + len(admm.kernel_instances(4200)) == \
        before + 3
    assert admm.LONG_LAUNCHES == before_long + 1
    res_p, state_p = admm.admm_all_prefixes_l2_reference(
        z, y, admm.admm_prologue(z), iters=100, tol=0.0, check_every=100,
        rho=1.0, alpha=1.7)
    assert _max_err(state, state_p) <= TOL[torch.float32]
    assert _max_err((res.reshape(-1),), (res_p,)) <= TOL[torch.float32]


@pytest.mark.parametrize("tol", [0.0, 2e-4])
def test_admm_long_rows_keep_the_identities(cuda, tol):
    """Rows p < 4,096 of a T = 4,200 launch equal the launch on
    z[:, :4096] and 50 + 50 iterations equal 100, bit for bit."""
    z, y = _admm_batch(2, 4200, 5, seed=44, cuda=cuda)
    kw = dict(tol=tol, check_every=50)
    X, res, st = admm.admm_all_prefixes_l2(z, y, iters=100, **kw)
    before, before_long = admm.LAUNCHES, admm.LONG_LAUNCHES
    X4, r4, _ = admm.admm_all_prefixes_l2(z[:, :4096].contiguous(),
                                          y[:, :4096].contiguous(),
                                          iters=100, **kw)
    torch.cuda.synchronize()
    # T = 4,096: the two register instances, no K10l (the C entry's count).
    assert (admm.LAUNCHES - before, admm.LONG_LAUNCHES - before_long) == \
        (2, 0)
    assert torch.equal(X[:, :4096], X4) and torch.equal(res[:, :4096], r4)
    if tol == 0.0:
        _, _, st1 = admm.admm_all_prefixes_l2(z, y, iters=50, **kw)
        Xc, rc, stc = admm.admm_all_prefixes_l2(z, y, iters=50, state0=st1,
                                                **kw)
        assert torch.equal(Xc, X) and torch.equal(rc, res)
        assert all(torch.equal(a, b) for a, b in zip(stc, st))
    s = st[0].reshape(2, 4200, 4200)
    past = torch.arange(4200, device=cuda)[None, :] > \
        torch.arange(4200, device=cuda)[:, None]
    assert bool((s[:, past] == 0).all())


@pytest.mark.parametrize("d,tol", [(5, 0.0), (5, 2e-4), (8, 0.0), (3, 2e-4)])
def test_admm_long_instances_match_plain(cuda, d, tol):
    """At T = 8,200 K10l's resident instance takes the rows of 4,097 to
    8,192 entries and its streaming instance the eight longer ones: four
    launches, two of them K10l's, one resident; every row within 5e-4 of
    the plain version, at the d = 5 instance and the generic one."""
    z, y = _admm_batch(1, 8200, d, seed=50 + d, cuda=cuda)
    kw = dict(iters=100, tol=tol, check_every=50)
    before = (admm.LAUNCHES, admm.LONG_LAUNCHES, admm.RESIDENT_LAUNCHES)
    X, res, state = admm.admm_all_prefixes_l2(z, y, **kw)
    torch.cuda.synchronize()
    assert admm.kernel_instances(8200) == ["long", "resident", 16, 8]
    assert (admm.LAUNCHES - before[0], admm.LONG_LAUNCHES - before[1],
            admm.RESIDENT_LAUNCHES - before[2]) == (4, 2, 1)
    res_p, state_p = admm.admm_all_prefixes_l2_reference(
        z, y, admm.admm_prologue(z), rho=1.0, alpha=1.7, **kw)
    assert _max_err(state, state_p) <= TOL[torch.float32]
    assert _max_err((res.reshape(-1),), (res_p,)) <= TOL[torch.float32]
    occ = admm.kernel_occupancy(8200, d)
    assert occ["long"][1] > 0
    assert occ["resident"][1] == 8 * admm.resident_plan(d)["groups"]


@pytest.mark.parametrize("d,stages", [(5, 5), (8, 3), (3, 3)])
def test_resident_plan_fits_a_block(cuda, d, stages):
    """K10l's resident block as its source sizes it: four rows in two
    groups of 256 threads, 32 entries a thread a row, 16 of a thread's 64
    in registers; its state in shared memory, the ring and the statics fit
    a block's 227 KB on an H100 and one more stage would not; every thread
    has at least 16 entries of every row, more than the ring's stages,
    which its cyclic fetch needs."""
    plan = admm.resident_plan(d)
    assert (plan["rows"], plan["groups"], plan["group_rows"],
            plan["threads"], plan["entries"], plan["register_entries"],
            plan["shared_entries"]) == (4, 2, 2, 512, 32, 16, 48)
    assert plan["stages"] == stages
    stage = ((5 if d == 5 else 8) + 1) * 256 * 4
    assert plan["smem_bytes"] == 48 * 8 * 512 + stages * stage
    total = plan["smem_bytes"] + plan["static_bytes"]
    assert total <= trs.H100_SMEM_OPTIN < total + stage + 256
    assert admm.LONG_ROWS // 256 >= 16 > plan["stages"]


@pytest.mark.parametrize("tol", [0.0, 2e-4])
def test_admm_long_instances_keep_the_identities(cuda, tol):
    """Rows p < T' of a T = 8,200 launch equal the launch on z[:, :T'] in
    every bit, for T' = 8,192 (no streaming rows) and 4,203 (the resident
    rows in other row slots); 50 + 50 iterations equal 100; a replicate
    alone equals its rows in the batch."""
    z, y = _admm_batch(2, 8200, 5, seed=46, cuda=cuda)
    kw = dict(tol=tol, check_every=50)
    X, res, st = admm.admm_all_prefixes_l2(z, y, iters=100, **kw)
    for Tc in (8192, 4203):
        Xc, rc, stc = admm.admm_all_prefixes_l2(z[:, :Tc].contiguous(),
                                                y[:, :Tc].contiguous(),
                                                iters=100, **kw)
        assert torch.equal(X[:, :Tc], Xc) and torch.equal(res[:, :Tc], rc)
        s = st[0].reshape(2, 8200, 8200)[:, :Tc]
        assert torch.equal(s[..., :Tc], stc[0].reshape(2, Tc, Tc))
        assert bool((s[..., Tc:] == 0).all())
        del Xc, rc, stc, s
    if tol == 0.0:
        _, _, st1 = admm.admm_all_prefixes_l2(z, y, iters=50, **kw)
        Xc, rc, stc = admm.admm_all_prefixes_l2(z, y, iters=50, state0=st1,
                                                **kw)
        assert torch.equal(Xc, X) and torch.equal(rc, res)
        assert all(torch.equal(a, b) for a, b in zip(stc, st))
        del st1, stc
    X1, r1, _ = admm.admm_all_prefixes_l2(z[1:].contiguous(),
                                          y[1:].contiguous(), iters=100,
                                          **kw)
    assert torch.equal(X[1:], X1) and torch.equal(res[1:], r1)


def _wide_problems(N, d, dtype, cuda, seed):
    z, y, _ = device_data.regression_stream_batch(
        torch.Generator(device=cuda).manual_seed(seed), 1, N, d,
        dtype=dtype)
    A = torch.cumsum(z[0, :, :, None] * z[0, :, None, :], 0)
    b = torch.cumsum(y[0, :, None] * z[0], 0)
    return A.contiguous(), b.contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [32, 33, 64])
def test_trs_instances_either_side_of_the_boundary(cuda, dtype, d):
    """K9 at d = 32 and K9w above it equal the plain version bit for bit
    on prefix statistics (singular ones included), a permuted batch the
    permuted output; each launch counted on its own instance."""
    A, b = _wide_problems(3 * d // 2 + 5, d, dtype, cuda, seed=d)
    thin, wide = trs.TRS_LAUNCHES, trs.TRS_WIDE_LAUNCHES
    x = trs.trs_solve(A, b)
    torch.cuda.synchronize()
    assert (trs.TRS_LAUNCHES - thin, trs.TRS_WIDE_LAUNCHES - wide) == \
        ((0, 1) if d > trs.MAX_D else (1, 0))
    assert torch.equal(x, trs.trs_solve_reference(A, b))
    perm = torch.randperm(A.shape[0], device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(1))
    assert torch.equal(trs.trs_solve(A[perm], b[perm]), x[perm])


def test_trs_wide_scratch_workspace(cuda):
    """At d = 240 in f64 a warp's workspace (one triangle and six vectors)
    passes shared memory and lives in device scratch: the same bits as the
    plain version."""
    plan = trs.wide_plan("K9w", 240, torch.float64, 6)
    assert plan["scratch"] > 0 and plan["smem_bytes"] == 0
    A, b = _wide_problems(6, 240, torch.float64, cuda, seed=5)
    b = b * torch.tensor([0.01, 0.1, 1.0, 3.0, 10.0, 100.0],
                         dtype=torch.float64, device=cuda)[:, None]
    passes = torch.zeros(6, dtype=torch.int32, device=cuda)
    x = trs.launch_trs_solve(A, b, passes)
    assert torch.equal(x, trs.trs_solve_reference(A, b))
    rows, cols = trs.tri_index(240)
    _, want = trs.trs_action_settled([A[:, i, j] for i, j in zip(rows, cols)],
                                     [b[:, i] for i in range(240)])
    assert torch.equal(passes.long(), want)


def _wide_d(dtype, where):
    """d by name: a number, or the largest d whose workspace fits shared
    memory ("edge") and the one past it ("past")."""
    edge = trs.wide_shared_max_d(dtype)
    return {"edge": edge, "past": edge + 1}.get(where) or int(where)


def _settled_passes(A, b):
    d = b.shape[-1]
    rows, cols = trs.tri_index(d)
    return trs.trs_action_settled([A[:, i, j] for i, j in zip(rows, cols)],
                                  [b[:, i] for i in range(d)])[1]


WIDE_CASES = ["33", "64", "65", "128", "edge", "past"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("where", WIDE_CASES)
def test_wide_solve_equals_plain_bit_for_bit(cuda, dtype, where):
    """K9w at d = 33, 64, 65 and 128, at the largest d whose workspace fits
    shared memory and one past it: x equals trs_solve_reference and each
    solve's passes trs_action_settled's, bit for bit, on prefix statistics
    (singular ones included) with b scaled so that solves end inside the
    ball and on it; the plan keeps the workspace in shared memory up to the
    boundary (at the bytes of wide_layout) and in scratch past it."""
    d = _wide_d(dtype, where)
    plan = trs.wide_plan("K9w", d, dtype, 1 << 20)
    assert (plan["smem_bytes"] > 0) == (d <= trs.wide_shared_max_d(dtype))
    assert plan["smem_bytes"] in (0, trs.wide_layout(d, dtype)["bytes"])
    if d <= 128:
        A, b = _wide_problems(3 * d // 2 + 5, d, dtype, cuda, seed=d)
    else:                   # 12 prefixes of d - 3 .. d + 8 rows
        A, b = _wide_problems(d + 8, d, dtype, cuda, seed=d)
        A, b = A[-12:].contiguous(), b[-12:].contiguous()
    scale = torch.logspace(-2, 2, b.shape[0], dtype=dtype, device=cuda)
    b = (b * scale[:, None]).contiguous()
    passes = torch.zeros(b.shape[0], dtype=torch.int32, device=cuda)
    x = trs.launch_trs_solve(A, b, passes)
    assert torch.equal(x, trs.trs_solve_reference(A, b))
    assert torch.equal(passes.long(), _settled_passes(A, b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("where", WIDE_CASES)
def test_wide_game_equals_plain_bit_for_bit(cuda, dtype, where):
    """K8w at the same d: FTRL and FTL sequences in one launch equal
    quadratic_regrets_reference bit for bit, x_c equals K9w on the final
    statistics, and each solve's passes (every FTL round's and the
    comparator's) equal trs_action_settled's on its prefix."""
    d = _wide_d(dtype, where)
    B, T = (4, 24) if d <= 128 else (3, 3)
    z, y, _ = device_data.regression_stream_batch(
        torch.Generator(device=cuda).manual_seed(d + 7), B, T, d,
        dtype=dtype)
    flags = torch.tensor([1, 0, 1, 1][:B], dtype=torch.int32, device=cuda)
    eta = torch.linspace(0.5, 2.0, B, dtype=dtype, device=cuda)
    z_tm, y_tm = game.time_major(z, y)
    passes = torch.zeros((T + 1, B), dtype=torch.int32, device=cuda)
    got = trs.launch_quadratic_regrets_wide(z_tm, y_tm, flags, eta, passes)
    want = trs.quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    A_pre = z.new_zeros((T + 1, B, d, d))
    b_pre = z.new_zeros((T + 1, B, d))
    for t in range(T):
        A_pre[t + 1] = A_pre[t] + z[:, t, :, None] * z[:, t, None, :]
        b_pre[t + 1] = b_pre[t] + y[:, t, None] * z[:, t]
    assert torch.equal(got[2], trs.trs_solve(A_pre[T], b_pre[T]).t())
    settled = _settled_passes(A_pre.reshape(-1, d, d),
                              b_pre.reshape(-1, d)).reshape(T + 1, B)
    settled[:T] = torch.where(flags == 1, settled[:T], 0)
    assert torch.equal(passes.long(), settled)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [32, 33, 40])
def test_quadratic_instances_either_side_of_the_boundary(cuda, dtype, d):
    """K8 at d = 32 and K8w above it against the plain version bit for
    bit, FTRL and FTL in one launch, and x_c equal to K9(w) on the final
    statistics."""
    z, y, _ = device_data.regression_stream_batch(
        torch.Generator(device=cuda).manual_seed(d), 6, 45, d, dtype=dtype)
    flags = torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.int32, device=cuda)
    eta = torch.linspace(0.5, 2.0, 6, dtype=dtype, device=cuda)
    z_tm, y_tm = game.time_major(z, y)
    thin, wide = trs.QUAD_LAUNCHES, trs.QUAD_WIDE_LAUNCHES
    got = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
    torch.cuda.synchronize()
    assert (trs.QUAD_LAUNCHES - thin, trs.QUAD_WIDE_LAUNCHES - wide) == \
        ((0, 1) if d > trs.MAX_D else (1, 0))
    want = trs.quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    A = z.new_zeros((6, d, d))
    b = z.new_zeros((6, d))
    for t in range(45):
        A = A + z[:, t, :, None] * z[:, t, None, :]
        b = b + y[:, t, None] * z[:, t]
    assert torch.equal(got[2], trs.trs_solve(A, b).t())


def test_quadratic_wide_pass_counts(cuda):
    """K8w's pass counts: each FTL round's solve and the comparator's, as
    the plain mirror of the Newton exit counts them; 0 on FTRL rounds."""
    d, T = 36, 40
    z, y, _ = device_data.regression_stream_batch(
        torch.Generator(device=cuda).manual_seed(3), 4, T, d,
        dtype=torch.float64)
    flags = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=cuda)
    eta = torch.ones(4, dtype=torch.float64, device=cuda)
    z_tm, y_tm = game.time_major(z, y)
    passes = torch.zeros((T + 1, 4), dtype=torch.int32, device=cuda)
    trs.launch_quadratic_regrets_wide(z_tm, y_tm, flags, eta, passes)
    rows, cols = trs.tri_index(d)
    A = z.new_zeros((4, d, d))
    b = z.new_zeros((4, d))
    want = []
    for t in range(T + 1):
        _, p = trs.trs_action_settled([A[:, i, j] for i, j in zip(rows, cols)],
                                      [b[:, i] for i in range(d)])
        want.append(torch.where(flags == 1, p, 0) if t < T else p)
        if t < T:
            A = A + z[:, t, :, None] * z[:, t, None, :]
            b = b + y[:, t, None] * z[:, t]
    assert torch.equal(passes.long(), torch.stack(want))
