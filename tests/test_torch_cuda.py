"""Kernels K1-K10 on the card against their plain PyTorch versions; the
sweeps, the stream, the packed game (K3, K3e) and the generation-fused
game (K7) against K1 and K2; K8's comparator against K9; the quadratic
study and the exact track's kernel route against their CPU runs.

Needs a CUDA device and nvcc; skipped elsewhere.  This file imports only
torch, numpy and the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import functools
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
    """Past d = 512 no hinge kernel rejects d: K1, K2, K3, K3e, K4, K5, K6a,
    K6b and K7 launch their wide instances (each launch counter rises) and
    give finite outputs; a sweep of zero rows has zero regret."""
    z = torch.zeros((2, 4, 513), dtype=torch.float64, device=cuda)
    y = torch.ones((2, 4), dtype=torch.float64, device=cuda)
    z_tm, y_tm = game.time_major(z, y)
    counters = ((game, "LAUNCHES"), (smart, "LAUNCHES"),
                (game, "STREAM_LAUNCHES"), (game, "PACKED_LAUNCHES"),
                (game, "PACKED_ETA_LAUNCHES"), (game, "SWEEP_LAUNCHES"),
                (smart, "SWEEP_LAUNCHES"), (smart, "SWEEP_TAIL_LAUNCHES"),
                (game, "SYNTHETIC_LAUNCHES"))
    before = [getattr(m, n) for m, n in counters]
    outs = [
        game.regrets_fused(z, y, 0, 1.0)[0],
        smart.smart_regrets(z, y, 1.0, 1.0)[0],
        game.play_stream(z_tm, y_tm, 1.0, 0, game.zero_stream_carry(
            2, 513, torch.float64, cuda)).cum,
        game.play_packed(z_tm, y_tm, game.ftrl_scales(
            4, 1.0, dtype=torch.float64, device=cuda))[1],
        game.play_packed_eta(z_tm, y_tm, 1.0)[1],
        game.eta_sweep(z, y, [1.0]),
        smart.smart_sweep(z, y, [1.0], 1.0)[0],
        game.synthetic_regrets(0, 1.0, T=4, lane_batch=1, d=513,
                               device=cuda)]
    torch.cuda.synchronize()
    # K2w is two launches: its FTL track, then its tails.
    rises = [2 if (m, n) == (smart, "LAUNCHES") else 1 for m, n in counters]
    assert [getattr(m, n) for m, n in counters] == [
        b + r for b, r in zip(before, rises)]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert float(outs[5].abs().max()) == 0.0 == float(outs[6].abs().max())


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
    smart.launch_smart_tails(zt, yt, scales, perm, order, lt, tau_a, comp,
                             tails)
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
    """K7 takes d = 512 (its large-d instance) and d = 513 (K7w), each a
    launch, and equals its plain version at both."""
    for d in (512, 513):
        before = game.SYNTHETIC_LAUNCHES
        out = game.synthetic_regrets(0, 1.0, T=4, lane_batch=1, d=d)
        torch.cuda.synchronize()
        assert game.SYNTHETIC_LAUNCHES == before + 1
        assert torch.equal(out, game.synthetic_regrets_reference(
            0, 1.0, T=4, lane_batch=1, d=d, device=cuda))


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


# --------------------------------------- K1w, K2w, K4w: d past 512

WIDE_CASES = ([(pair, d) for pair in [(torch.float64, torch.float64),
                                      (torch.float32, torch.float32)]
               + STORAGE_PAIRS for d in (513, 1024)]
              + [((torch.float64, torch.float64), 2048)])


def _wide_vs_plain(cuda, pair, d, contract, T, ths, cuts):
    """K1w (two plays, and one play a sequence with mixed flags and etas),
    K2w (the thresholds ``ths(dtype)``) and K4w (chunks from a carry, split
    at ``cuts``) against their plain versions on the stored values in every
    bit, B = 77, ragged lengths; returns K2w's switch rounds and the
    lengths."""
    B = 77
    z, y, lengths = _batch(B, T, d, seed=d + 7, contract=True)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    dtype = zf.dtype
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    assert game.in_contract(zs, ys, ln) == contract
    eta = game.per_sequence(1.3, B, dtype, cuda)
    before = (game.LAUNCHES, smart.LAUNCHES, game.STREAM_LAUNCHES)
    got = game.regret_plays(zs, ys, (0, 1), 1.3, ln, not contract)
    flags = torch.tensor([[0] * B, [1] * B], dtype=torch.int32, device=cuda)
    want = game.regret_plays_reference(zf, yf, flags, eta, ln,
                                       replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fl = game.per_sequence(np.arange(B) % 2, B, torch.int32, cuda)
    et = torch.linspace(0.3, 2.5, B, dtype=dtype, device=cuda)
    got = game.regrets_fused(zs, ys, fl, et, ln)
    want = game.regrets_fused_reference(zf, yf, fl, et, ln,
                                        replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = smart.smart_plays(zs, ys, ths(dtype), 1.3, ln, not contract)
    want = smart.smart_plays_reference(zf, yf, ths(dtype), eta, ln,
                                       replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    z_tm, y_tm = game.time_major(zs, ys)
    zf_tm, yf_tm = game.time_major(zf, yf)
    carry = want_carry = game.zero_stream_carry(B, d, dtype, cuda)
    for lo, hi in zip(cuts, cuts[1:]):
        carry = game.play_stream(z_tm[lo:hi], y_tm[lo:hi], et, lo, carry,
                                 alg_flag=fl)
        want_carry = game.play_stream_reference(zf_tm[lo:hi], yf_tm[lo:hi],
                                                fl, et, lo, want_carry)
    assert all(torch.equal(g, w) for g, w in zip(carry, want_carry))
    torch.cuda.synchronize()
    # K2w is two launches: its FTL track, then its tails.
    assert (game.LAUNCHES, smart.LAUNCHES, game.STREAM_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2] + len(cuts) - 1)
    return got[3], ln


@pytest.mark.parametrize("pair,d", WIDE_CASES)
@pytest.mark.parametrize("contract", [True, False])
def test_wide_kernels_equal_plain_bit_for_bit(cuda, pair, d, contract):
    """K1w, K2w (two thresholds a sequence, one that no sequence reaches)
    and K4w (two chunks from a carry) equal their plain versions on the
    stored values in every bit, ragged lengths, in contract and replay
    mode."""
    T = 20

    def ths(dtype):
        return torch.stack([
            torch.linspace(0.3, 3.0, 77, dtype=dtype, device=cuda),
            torch.full((77,), 1e30, dtype=dtype, device=cuda)])

    tau, _ = _wide_vs_plain(cuda, pair, d, contract, T, ths, (0, 7, T))
    assert bool((tau[0] < T).any()) and bool((tau[1] == T).all())


# K1w plays a launch in chunks of 64 rounds (oco_tiles.cuh kMaxChunk): T =
# 200 plays 4, so that stages are reused and the barriers' parity flips;
# K2w's tails start at switches spread over those rounds.
WIDE_CHUNK = 64


@pytest.mark.parametrize("pair,contract", [
    ((torch.float64, torch.float64), True),
    ((torch.float32, torch.float32), False)])
def test_wide_kernels_equal_plain_across_chunks(cuda, pair, contract):
    """K1w, K2w and K4w at d = 513 over T = 200 rounds (4 chunks), ragged
    lengths, with thresholds spread so that pairs switch in each of the
    first three chunks and tails play past their switch's chunk, equal
    their plain versions in every bit."""
    T = 200
    root = math.sqrt(2.0 * T)

    def ths(dtype):
        return torch.stack([
            torch.linspace(0.05, 0.4, 77, dtype=dtype, device=cuda) * root,
            torch.linspace(0.3, 0.9, 77, dtype=dtype, device=cuda) * root])

    tau, ln = _wide_vs_plain(cuda, pair, 513, contract, T, ths,
                             (0, 50, 137, T))
    ln = ln[None].long()
    on = tau < ln
    for lo in range(0, 3 * WIDE_CHUNK, WIDE_CHUNK):
        assert bool((on & (tau >= lo) & (tau < lo + WIDE_CHUNK)).any())
    assert bool((on & ((tau // WIDE_CHUNK + 1) * WIDE_CHUNK < ln - 1)).any())


@pytest.mark.parametrize("d", [513, 1024])
def test_wide_identities(cuda, d):
    """f64: K4w fed in chunks equals one K1w launch; K2w with a threshold no
    sequence reaches gives K1w's FTL play's losses with tau = T; a narrow
    storage pair equals the f32 launch on the upcast values."""
    B, T = 64, 48
    z, y, _ = _batch(B, T, d, seed=d + 3)
    zt, yt = _to((z, y), cuda, torch.float64)
    ln = torch.full((B,), T, dtype=torch.int32, device=cuda)
    cum, comp, _ = game.regret_plays(zt, yt, (0, 1), 1.3, ln, False)
    kg = StreamingKernelGame(B, d, alg_flag=1, eta0=1.3, dtype=torch.float64,
                             device=cuda)
    z_tm, y_tm = game.time_major(zt, yt)
    for lo in range(0, T, 16):
        kg.feed_packed(z_tm[lo:lo + 16], y_tm[lo:lo + 16])
    res = kg.result()
    assert torch.equal(res.cum_loss, cum[1])
    assert torch.equal(res.comp_loss, comp[1])
    ths = torch.full((1, B), 1e30, dtype=torch.float64, device=cuda)
    s_cum, s_comp, _, tau = smart.smart_plays(zt, yt, ths, 1.3, ln, False)
    assert torch.equal(s_cum[0], cum[1]) and torch.equal(s_comp, comp[1])
    assert bool((tau == T).all())
    zs, ys, zf, yf = _stored(z, y, (torch.bfloat16, torch.int8), cuda)
    narrow = game.regret_plays(zs, ys, (0, 1), 1.3, ln, False)
    wide = game.regret_plays(zf, yf, (0, 1), 1.3, ln, False)
    assert all(torch.equal(a, b) for a, b in zip(narrow, wide))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wide_local_frame_does_not_grow_with_d(cuda, dtype):
    """Each wide instance reports the same local frame at every d past 512,
    smaller than one state array of the large-d instance (512 elements):
    no array sized by d sits in a thread's frame."""
    occupancies = [
        ("K1", lambda d: game.regret_occupancy(2, d, dtype)),
        ("K2", lambda d: smart.smart_occupancy(2, d, dtype)),
        ("K3", lambda d: game.packed_occupancy(False, d, dtype)),
        ("K3e", lambda d: game.packed_occupancy(True, d, dtype)),
        ("K4", lambda d: game.stream_occupancy(d, dtype)),
        ("K5", lambda d: game.sweep_occupancy(d, dtype)),
        ("K6a", lambda d: smart.sweep_occupancy(False, d, dtype)),
        ("K6b", lambda d: smart.sweep_occupancy(True, d, dtype))]
    if dtype == torch.float32:
        occupancies += [("K7", lambda d: game.synthetic_occupancy(0, d)),
                        ("K7 FTL", lambda d: game.synthetic_occupancy(1, d))]
    for name, occ in occupancies:
        frames = {occ(d)[2] for d in (513, 1024, 4096, 65536)}
        assert len(frames) == 1, (name, frames)
        assert frames.pop() < 512 * dtype.itemsize, name
        regs, warps, _ = occ(1024)
        assert regs > 0 and warps > 0, name


def test_wide_entry_points_on_the_card(cuda):
    """The entry points a user calls take d = 513 on the card through K1w,
    K2w and K4w (their counters rise), within 1e-9 of their CPU runs in
    f64."""
    from online_convex_optimization_tpu_torch.models import (
        simulate_linear_batch, simulate_smart_batch)
    from online_convex_optimization_tpu_torch.models.streaming import (
        StreamingGame)
    B, T, d = 16, 24, 513
    z, y, lengths = _batch(B, T, d, seed=5)
    before = (game.LAUNCHES, smart.LAUNCHES, game.STREAM_LAUNCHES)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        zt, yt = _to((z, y), dev, torch.float64)
        feed = [(zt[:, lo:lo + 8].transpose(0, 1), yt[:, lo:lo + 8].t())
                for lo in range(0, T, 8)]
        sg = StreamingGame(B, d, eta0=1.1, dtype=torch.float64, device=dev)
        kg = StreamingKernelGame(B, d, alg_flag=1, dtype=torch.float64,
                                 device=dev)
        for zc, yc in feed:
            sg.feed(zc, yc)
            kg.feed(zc, yc)
        outs[dev.type] = (
            simulate_linear_batch(zt, yt, np.arange(B) % 2, 1.3,
                                  lengths).regret,
            simulate_smart_batch(zt, yt, 1.5, 1.3, lengths).regret,
            sg.result(feed).regret, kg.result().regret,
            game.simulate_linear_auto(zt, yt, 0, 1.3))
    torch.cuda.synchronize()
    assert game.LAUNCHES == before[0] + 2
    assert smart.LAUNCHES == before[1] + 2      # K2w's two launches
    assert game.STREAM_LAUNCHES == before[2] + 2 * len(range(0, T, 8))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _max_err((got.cpu(),), (want,)) <= TOL[torch.float64]


# ------------------------- K3w, K3ew, K5w, K6aw, K6bw, K7w: d past 512

WIDE_SWEEP_CASES = [(pair, d) for pair in [(torch.float64, torch.float64),
                                           (torch.float32, torch.float32)]
                    + STORAGE_PAIRS for d in (513, 1024)]


def _wide_sweeps_vs_plain(cuda, pair, d, contract, T, grid):
    """K5w (E = 3 settings), K6aw and K6bw (the thresholds ``grid`` times
    sqrt(2T)), K3w (FTRL from ``ftrl_scales``, FTL) and K3ew against their
    plain versions on the stored values in every bit, B = 77, ragged
    lengths (zero rows past them on the packed API); returns the switch
    rounds (B, G) and the lengths."""
    B = 77
    z, y, lengths = _batch(B, T, d, seed=d + 11, contract=True)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    dtype = zf.dtype
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    assert game.in_contract(zs, ys, ln) == contract
    etas = torch.tensor([0.1, 1.3, 3.7], dtype=dtype, device=cuda)
    ths = torch.as_tensor(np.asarray(grid) * math.sqrt(2.0 * T), dtype=dtype,
                          device=cuda)
    eta = torch.tensor(1.3, dtype=dtype, device=cuda)
    before = (game.SWEEP_LAUNCHES, smart.SWEEP_LAUNCHES,
              smart.SWEEP_TAIL_LAUNCHES, game.PACKED_LAUNCHES,
              game.PACKED_ETA_LAUNCHES)
    got = game.eta_sweep(zs, ys, etas, ln)
    want = game.eta_sweep_reference(zf, yf, etas, ln, replay=not contract)
    assert torch.equal(got, want)
    # K6aw alone against the split mirror's first part, then K6 whole.
    ordered, perm = torch.sort(ths, stable=True)
    got = smart.launch_smart_prefix(zs, ys, ordered, perm.to(torch.int32),
                                    game.length_order(ln), ln, not contract)
    want = smart.smart_prefix_reference(zf, yf, ths, ln, replay=not contract)
    assert all(torch.equal(g.t() if g.ndim == 2 else g, w)
               for g, w in zip(got, want))
    got = smart.smart_sweep(zs, ys, ths, 1.3, ln)
    want = smart.smart_sweep_reference(zf, yf, ths, eta, ln,
                                       replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    tau = got[1]
    valid = (torch.arange(T, device=cuda)[None, :] < ln[:, None].long())
    z_tm, y_tm = game.time_major(torch.where(valid[..., None], zs, 0),
                                 torch.where(valid, ys, 0))
    zf_tm, yf_tm = game.time_major(torch.where(valid[..., None], zf, 0.0),
                                   torch.where(valid, yf, 0.0))
    scales = game.ftrl_scales(T, 1.3, dtype=dtype, device=cuda)
    for flag in (0, 1):
        got = game.play_packed(z_tm, y_tm, scales, alg_flag=flag)
        want = game.play_packed_reference(zf_tm, yf_tm, scales, flag)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    per_seq = torch.linspace(0.3, 2.5, B, dtype=dtype, device=cuda)
    got = game.play_packed_eta(z_tm, y_tm, per_seq)
    want = game.play_packed_eta_reference(zf_tm, yf_tm, per_seq)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    assert (game.SWEEP_LAUNCHES, smart.SWEEP_LAUNCHES,
            smart.SWEEP_TAIL_LAUNCHES, game.PACKED_LAUNCHES,
            game.PACKED_ETA_LAUNCHES) == (before[0] + 1, before[1] + 2,
                                          before[2] + 1, before[3] + 2,
                                          before[4] + 1)
    return tau, ln


@pytest.mark.parametrize("pair,d", WIDE_SWEEP_CASES)
@pytest.mark.parametrize("contract", [True, False])
def test_wide_sweeps_and_packed_equal_plain_bit_for_bit(cuda, pair, d,
                                                        contract):
    """K5w, K6aw, K6bw, K3w and K3ew equal their plain versions on the
    stored values in every bit at d = 513 and 1,024, in f64, f32 and every
    narrow pair, contract and replay data, with a threshold that no pair
    reaches beside ones that some pairs pass."""
    tau, ln = _wide_sweeps_vs_plain(cuda, pair, d, contract, 20,
                                    [0.05, 0.2, 0.5, 1e30])
    assert bool((tau[:, 0] < 20).any()) and bool((tau[:, 3] == 20).all())


@pytest.mark.parametrize("pair,contract", [
    ((torch.float64, torch.float64), True),
    ((torch.float32, torch.float32), False)])
def test_wide_sweeps_equal_plain_across_chunks(cuda, pair, contract):
    """At d = 513 over T = 200 rounds (more than three of the thin sweeps'
    64-round chunks, oco_tiles.cuh kMaxChunk), with 13 thresholds spread so
    that pairs switch in each of the first three chunks and tails play past
    their switch's chunk, the wide instances equal their plain versions in
    every bit."""
    tau, ln = _wide_sweeps_vs_plain(cuda, pair, 513, contract, 200,
                                    np.linspace(0.03, 0.9, 13))
    ln = ln[:, None].long()
    on = tau < ln
    for lo in range(0, 3 * WIDE_CHUNK, WIDE_CHUNK):
        assert bool((on & (tau >= lo) & (tau < lo + WIDE_CHUNK)).any())
    assert bool((on & ((tau // WIDE_CHUNK + 1) * WIDE_CHUNK < ln - 1)).any())


@pytest.mark.parametrize("d", [513, 1024])
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_wide_synthetic_equals_plain_and_k1w(cuda, d, alg_flag):
    """K7w equals its plain version and K1w on synthetic_stream's rows of
    the same seed in every bit (d = 1,024 draws 9 Philox calls a round)."""
    before = game.SYNTHETIC_LAUNCHES
    got = game.synthetic_regrets(3 << 20, 1.3, T=70, lane_batch=4, d=d,
                                 alg_flag=alg_flag)
    torch.cuda.synchronize()
    assert game.SYNTHETIC_LAUNCHES == before + 1
    want = game.synthetic_regrets_reference(3 << 20, 1.3, T=70,
                                            lane_batch=4, d=d,
                                            alg_flag=alg_flag, device=cuda)
    assert torch.equal(got, want)
    z, y = game.synthetic_stream(3 << 20, T=70, lane_batch=4, d=d,
                                 device=cuda)
    cum, comp, _ = game.regrets_fused(z, y, alg_flag, 1.3)
    assert torch.equal(got.reshape(-1), cum - comp)


def _synthetic_boundary():
    return game.synthetic_plan(1024)["max_shared_d"]


@pytest.mark.parametrize("side", ["shared", "device memory"])
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_wide_synthetic_across_the_shared_boundary(cuda, side, alg_flag):
    """K7w at the largest d whose lines fit a block's shared memory (theta
    and w on the chip, no buffer) and one past it (theta, w and the words
    in the state buffer the plan asks for) equals its plain version in
    every bit at a small B and T; at d = 1,025 a last product line of one
    element."""
    boundary = _synthetic_boundary()
    for d in ((boundary, 1025) if side == "shared" else (boundary + 1,)):
        plan = game.synthetic_plan(d, alg_flag)
        assert plan["shared"] == (side == "shared")
        elems = game.wide_state_elems("K7", 8, d)
        assert (elems == 0) == (side == "shared")
        T = 3 if d > 2048 else 40
        before = game.SYNTHETIC_LAUNCHES
        got = game.synthetic_regrets(9 << 20, 1.3, T=T, lane_batch=1, d=d,
                                     alg_flag=alg_flag)
        torch.cuda.synchronize()
        assert game.SYNTHETIC_LAUNCHES == before + 1
        want = game.synthetic_regrets_reference(9 << 20, 1.3, T=T,
                                                lane_batch=1, d=d,
                                                alg_flag=alg_flag,
                                                device=cuda)
        assert torch.equal(got, want), d


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_synthetic_plan_fits_a_block(cuda, alg_flag):
    """The library's K7w plan: theta and w in shared memory exactly up to
    max_shared_d (the same for FTRL and FTL), a block's shared memory
    within the H100's 227 KB, no buffer where shared and a multiple of 4
    floats a sequence past it; the occupancy entry reports the plan's
    block: its shared bytes and at least its warps resident an SM."""
    boundary = _synthetic_boundary()
    assert 2048 < boundary < 65536
    assert game.synthetic_plan(1024, 1 - alg_flag)["max_shared_d"] == \
        boundary
    for d in (513, 1024, 2048, boundary, boundary + 1, 65536):
        plan = game.synthetic_plan(d, alg_flag)
        assert plan["shared"] == (d <= boundary), d
        assert 1 <= plan["warps"] <= 8
        assert 0 < plan["smem_bytes"] <= 232448
        assert plan["smem_bytes"] % (16 * plan["warps"]) == 0
        if plan["shared"]:
            assert plan["state"] == 0
        else:
            assert plan["state"] >= 2 * d and plan["state"] % 4 == 0
        regs, warps, _ = game.synthetic_occupancy(alg_flag, d)
        shared = game.occupancy("K7", game.cuda_build.load()
                                .oco_synthetic_occupancy, alg_flag, d,
                                shared=True)[3]
        assert regs > 0 and warps >= plan["warps"], d
        assert shared == plan["smem_bytes"], d
    with pytest.raises(RuntimeError, match="K7w plan failed"):
        game.synthetic_plan(512, alg_flag)


# ------------------------------------- K3w and K6aw: a sequence a warp

ALL_PAIRS = [(torch.float64, torch.float64),
             (torch.float32, torch.float32)] + STORAGE_PAIRS


def _warp_plans(pair, d):
    """K3w's and K6aw's plans at d for z stored in ``pair[0]``."""
    return game.packed_plan(d, pair[0]), game.prefix_plan(d, pair[0])


def _k3w_k6aw_vs_plain(cuda, pair, d, T, contract, B=77):
    """K3w (FTRL with eta = 4, so that rounds project, and FTL) and K6aw
    (identity or replay comparator, thresholds that switch early, late and
    never) against their plain versions on the stored values in every bit,
    at B sequences with ragged lengths (zero rows past them on the packed
    API); each launch's state buffer is the one its plan asks for."""
    z, y, lengths = _batch(B, T, d, seed=d + 29, contract=True)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    assert game.in_contract(zs, ys, ln) == contract
    ths = torch.as_tensor(np.array([0.02, 0.1, 0.3, 1e30]) *
                          math.sqrt(2.0 * T), dtype=zf.dtype, device=cuda)
    ordered, perm = torch.sort(ths, stable=True)
    p3, p6 = _warp_plans(pair, d)
    assert game.wide_state_elems("K3", B, d, 1, pair[0]) == p3["state"] * B
    assert game.wide_state_elems("K6a", B, d, 1, pair[0]) == p6["state"] * B
    before = (game.PACKED_LAUNCHES, smart.SWEEP_LAUNCHES)
    got = smart.launch_smart_prefix(zs, ys, ordered, perm.to(torch.int32),
                                    game.length_order(ln), ln, not contract)
    want = smart.smart_prefix_reference(zf, yf, ths, ln, replay=not contract)
    assert all(torch.equal(g.t() if g.ndim == 2 else g, w)
               for g, w in zip(got, want)), ("K6aw", pair, d, contract)
    valid = (torch.arange(T, device=cuda)[None, :] < ln[:, None].long())
    z_tm, y_tm = game.time_major(torch.where(valid[..., None], zs, 0),
                                 torch.where(valid, ys, 0))
    zf_tm, yf_tm = game.time_major(torch.where(valid[..., None], zf, 0.0),
                                   torch.where(valid, yf, 0.0))
    scales = game.ftrl_scales(T, 4.0, dtype=zf.dtype, device=cuda)
    for flag in (0, 1):
        got = game.play_packed(z_tm, y_tm, scales, alg_flag=flag)
        want = game.play_packed_reference(zf_tm, yf_tm, scales, flag)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (
            "K3w", pair, d, flag)
    torch.cuda.synchronize()
    assert (game.PACKED_LAUNCHES, smart.SWEEP_LAUNCHES) == (
        before[0] + 2, before[1] + 1)
    return got


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("d", [513, 1024, 2048])
def test_k3w_k6aw_equal_plain_in_every_pair(cuda, pair, d):
    """K3w and K6aw equal their plain versions in every bit in every
    storage pair at d = 513, 1,024 and 2,048, B = 77 (a multiple of no
    block's warps), contract and replay data; bf16 at d = 2,048 lies past
    K3w's shared boundary."""
    for contract in (True, False):
        _k3w_k6aw_vs_plain(cuda, pair, d, 12, contract)
    # A full last block of warps (B a multiple of 16, 8 and 4).
    _k3w_k6aw_vs_plain(cuda, pair, d, 12, True, B=48)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("kernel", ["K3w", "K6aw"])
def test_k3w_k6aw_across_the_shared_boundary(cuda, pair, kernel):
    """At the largest d whose state fits a block's shared memory and one
    past it (the state buffer the plan asks for), each instance equals its
    plain version in every bit; its plan says which side it is on."""
    plan = _warp_plans(pair, 1024)[kernel == "K6aw"]
    boundary = plan["max_shared_d"]
    for d, shared in ((boundary, True), (boundary + 1, False)):
        assert _warp_plans(pair, d)[kernel == "K6aw"]["shared"] == shared
        for contract in (True, False):
            _k3w_k6aw_vs_plain(cuda, pair, d, 3, contract, B=21)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("shared", [True, False])
def test_k3w_reads_an_offset_view(cuda, pair, shared):
    """K3w on a contiguous view that starts one row of the batch into its
    storage, ``z_tm[1:]`` with d B odd (a bf16 view 2 bytes past a 4-byte
    boundary), equals its plain version in every bit, FTRL and FTL, on
    both sides of the shared boundary."""
    B, T = 77, 6
    d = 513 if shared else _warp_plans(pair, 1024)[0]["max_shared_d"] + 1
    d += 1 - d % 2                 # d B odd
    assert _warp_plans(pair, d)[0]["shared"] == shared
    z, y, _ = _batch(B, T + 1, d, seed=d + 31, contract=True)
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    z_tm, y_tm = game.time_major(zs, ys)
    zf_tm, yf_tm = game.time_major(zf, yf)
    view, labels = z_tm[1:], y_tm[1:]
    assert view.is_contiguous() and labels.is_contiguous()
    assert view.data_ptr() - z_tm.data_ptr() == d * B * zs.element_size()
    if pair[0] == torch.bfloat16:
        assert view.data_ptr() % 4 == 2
    scales = game.ftrl_scales(T, 4.0, dtype=zf.dtype, device=cuda)
    for flag in (0, 1):
        got = game.play_packed(view, labels, scales, alg_flag=flag)
        want = game.play_packed_reference(zf_tm[1:], yf_tm[1:], scales, flag)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (
            pair, d, flag)


@pytest.mark.parametrize("pair", ALL_PAIRS)
def test_k3w_k6aw_plans_fit_a_block(cuda, pair):
    """The library's plans: K3w a warp a sequence and 32 bytes of z a
    block at each (t, j) (4, 8, 16 warps in f64, f32, bf16), K6aw 1-8
    warps a block; state on the chip exactly up to max_shared_d (past the
    path's d = 1,024), a block within the H100's 227 KB, no buffer where
    shared and theta (K3w) or theta and w (K6aw), each padded to 4
    elements, past it; the occupancy entries report the plans' blocks: at
    d = 1,024 the path's sequences fit one wave (K3w f32, bf16: 16 warps an
    SM; K6aw f64: 8)."""
    zt = pair[0]
    k3 = game.packed_plan(1024, zt)
    k6 = game.prefix_plan(1024, zt)
    assert k3["warps"] == 32 // zt.itemsize and 1 <= k6["warps"] <= 8
    for plan in (k3, k6):
        assert 1024 < plan["max_shared_d"] < 65536
    for d in (513, 1024, 2048, k3["max_shared_d"], k3["max_shared_d"] + 1,
              k6["max_shared_d"], k6["max_shared_d"] + 1, 65536):
        up4 = -(-d // 4) * 4
        for kernel, plan, state in (
                ("K3w", game.packed_plan(d, zt), up4),
                ("K6aw", game.prefix_plan(d, zt), 2 * up4)):
            boundary = (k3 if kernel == "K3w" else k6)["max_shared_d"]
            assert plan["shared"] == (d <= boundary), (kernel, d)
            assert plan["state"] == (0 if plan["shared"] else state)
            assert 0 < plan["smem_bytes"] <= 232448
            assert plan["smem_bytes"] % 16 == 0
            occ = (game.packed_occupancy(False, d, zt) if kernel == "K3w"
                   else smart.sweep_occupancy(False, d, zt))
            entry, *args = (
                (game.cuda_build.load().oco_packed_occupancy,
                 game.storage_code(zt), 0) if kernel == "K3w" else
                (game.cuda_build.load().oco_smart_sweep_occupancy,
                 game.storage_code(zt), 0))
            shared = game.occupancy(kernel, entry, *args, d, shared=True)[3]
            assert occ[0] > 0 and occ[1] >= plan["warps"], (kernel, d)
            assert shared == plan["smem_bytes"], (kernel, d)
    if zt in (torch.float32, torch.bfloat16):
        assert game.packed_occupancy(False, 1024, zt)[1] >= 16
    if zt == torch.float64:
        assert smart.sweep_occupancy(False, 1024, zt)[1] >= 8
    for fn in (game.packed_plan, game.prefix_plan):
        with pytest.raises(RuntimeError, match="plan failed"):
            fn(512, zt)


# ---------------------------------------- K1w and K4w: a play or a sequence a warp

def _k1w_k4w_plans(pair, d, plays=2):
    """K1w's plan with ``plays`` plays and K4w's at d for z stored in
    ``pair[0]``."""
    return game.regret_plan(d, plays, pair[0]), game.stream_plan(d, pair[0])


def _k1w_k4w_vs_plain(cuda, pair, d, T, contract, B=77, offset=0):
    """K1w (FTRL and FTL plays of one copy of z with eta = 4, so that rounds
    project; three plays with flags FTL, FTRL, FTL; one play a sequence
    with mixed flags and etas) and K4w (mixed flags and etas, three chunks
    from a zero carry, t0 > 0 after the first) against their plain
    versions on the stored values in every bit, at B sequences with ragged
    lengths, identity or replay comparator; each launch's state buffer is
    the one its plan asks for.  ``offset`` 1 plays views that start one
    sequence (K1w) and one round (K4w) into their storage."""
    z, y, lengths = _batch(B + offset, T + offset, d, seed=d + 37,
                           contract=True)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    dtype = zf.dtype
    # K4w's rows: the first B sequences time-major, from round `offset` on;
    # K1w's: (B + offset, T, d), from sequence `offset` on.
    z_tm, y_tm, zf_tm, yf_tm = (
        t[offset:] for t in (*game.time_major(zs[:B], ys[:B]),
                             *game.time_major(zf[:B], yf[:B])))
    zs, ys, zf, yf = (t[:, :T].contiguous()[offset:]
                      for t in (zs, ys, zf, yf))
    assert zs.is_contiguous() and z_tm.is_contiguous()
    ln = game.per_sequence(np.minimum(lengths[offset:], T), B, torch.int32,
                           cuda)
    assert game.in_contract(zs, ys, ln) == contract
    for plays in (1, 2, 3):
        assert game.wide_state_elems("K1", B, d, plays, pair[0]) == (
            game.regret_plan(d, plays, pair[0])["state"] * B)
    assert game.wide_state_elems("K4", B, d, 1, pair[0]) == (
        game.stream_plan(d, pair[0])["state"] * B)
    before = (game.LAUNCHES, game.STREAM_LAUNCHES)
    eta = game.per_sequence(4.0, B, dtype, cuda)
    for plays in ((0, 1), (1, 0, 1)):
        got = game.regret_plays(zs, ys, plays, 4.0, ln, not contract)
        flags = torch.tensor([[f] * B for f in plays], dtype=torch.int32,
                             device=cuda)
        want = game.regret_plays_reference(zf, yf, flags, eta, ln,
                                           replay=not contract)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (
            "K1w", plays, pair, d, contract)
    fl = game.per_sequence(np.arange(B) % 2, B, torch.int32, cuda)
    et = torch.linspace(0.3, 4.0, B, dtype=dtype, device=cuda)
    got = game.regrets_fused(zs, ys, fl, et, ln)
    want = game.regrets_fused_reference(zf, yf, fl, et, ln,
                                        replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (
        "K1w one play", pair, d, contract)
    cuts = (0, T // 3, T - T // 3, T)
    carry = want_carry = game.zero_stream_carry(B, d, dtype, cuda)
    for lo, hi in zip(cuts, cuts[1:]):
        carry = game.play_stream(z_tm[lo:hi], y_tm[lo:hi], et, lo, carry,
                                 alg_flag=fl)
        want_carry = game.play_stream_reference(zf_tm[lo:hi], yf_tm[lo:hi],
                                                fl, et, lo, want_carry)
    assert all(torch.equal(g, w) for g, w in zip(carry, want_carry)), (
        "K4w", pair, d)
    torch.cuda.synchronize()
    assert (game.LAUNCHES, game.STREAM_LAUNCHES) == (before[0] + 3,
                                                     before[1] + 3)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("d", [513, 1024, 2048])
def test_k1w_k4w_equal_plain_in_every_pair(cuda, pair, d):
    """K1w and K4w equal their plain versions in every bit in every storage
    pair at d = 1,024 and 2,048 and 513, B = 77 (a multiple of no block's
    warps) and 48 (a full last block), contract and replay data; bf16 at
    d = 2,048 lies past K4w's shared boundary."""
    for contract in (True, False):
        _k1w_k4w_vs_plain(cuda, pair, d, 12, contract)
    _k1w_k4w_vs_plain(cuda, pair, d, 12, True, B=48)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("kernel", ["K1w", "K4w"])
def test_k1w_k4w_across_the_shared_boundary(cuda, pair, kernel):
    """At the largest d whose state fits a block's shared memory (K1w: with
    two plays) and one past it (the state buffer the plan asks for), each
    instance equals its plain version in every bit; its plan says which
    side it is on."""
    plan = _k1w_k4w_plans(pair, 1024)[kernel == "K4w"]
    boundary = plan["max_shared_d"]
    for d, shared in ((boundary, True), (boundary + 1, False)):
        assert _k1w_k4w_plans(pair, d)[kernel == "K4w"]["shared"] == shared
        for contract in (True, False):
            _k1w_k4w_vs_plain(cuda, pair, d, 3, contract, B=21)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("shared", [True, False])
def test_k1w_k4w_read_offset_views(cuda, pair, shared):
    """K1w on ``z[1:]`` and K4w on ``z_tm[1:]``, contiguous views one
    sequence or one round into their storage with T d and d B odd (bf16
    views 2 bytes past a 4-byte boundary), equal their plain versions in
    every bit, on both sides of each plan's shared boundary."""
    k1, k4 = _k1w_k4w_plans(pair, 1024)
    d = 513 if shared else max(k1["max_shared_d"], k4["max_shared_d"]) + 1
    d += 1 - d % 2
    assert all(p["shared"] == shared for p in _k1w_k4w_plans(pair, d))
    _k1w_k4w_vs_plain(cuda, pair, d, 5, True, B=77, offset=1)


@pytest.mark.parametrize("pair", ALL_PAIRS)
def test_k1w_k4w_plans_fit_a_block(cuda, pair):
    """The library's plans: K1w a block a sequence and a warp a play (1-8),
    K4w a warp a sequence and 32 bytes of z a block at each (t, j) (4, 8,
    16 warps in f64, f32, bf16); state on the chip exactly up to
    max_shared_d (past the path's d = 2,048 for K1w with two plays, past
    1,024 for K4w), a block within the H100's 227 KB, no buffer where
    shared, and past it the plays' thetas and w (K1w) or theta and w
    (K4w), each padded to 4 elements; the occupancy entries report the plans' blocks,
    at d = 1,024 K4w f32's 2,048 sequences in one wave (16 warps an SM)."""
    zt = pair[0]
    k4 = game.stream_plan(1024, zt)
    assert k4["warps"] == 32 // zt.itemsize
    assert 1024 < k4["max_shared_d"] < 65536
    bounds = {plays: game.regret_plan(1024, plays, zt)["max_shared_d"]
              for plays in (1, 2, 8)}
    assert bounds[2] > 2048 and bounds[8] > 1024
    assert bounds[1] > bounds[2] > bounds[8]
    compute = game.compute_dtype(zt)
    for d in (513, 1024, 2048, k4["max_shared_d"], k4["max_shared_d"] + 1,
              bounds[2], bounds[2] + 1, 65536):
        up4 = -(-d // 4) * 4
        cases = [("K4w", game.stream_plan(d, zt), k4["max_shared_d"],
                  2 * up4,
                  lambda: game.stream_occupancy(d, compute),
                  game.cuda_build.load().oco_stream_occupancy, ())]
        for plays in (1, 2, 8):
            cases.append((
                "K1w", game.regret_plan(d, plays, zt), bounds[plays],
                (plays + 1) * up4,
                lambda p=plays: game.regret_occupancy(p, d, compute),
                game.cuda_build.load().oco_regrets_occupancy, (plays,)))
        for kernel, plan, boundary, state, occ, entry, args in cases:
            assert plan["warps"] == (k4["warps"] if kernel == "K4w"
                                     else args[0])
            assert plan["shared"] == (d <= boundary), (kernel, d)
            assert plan["state"] == (0 if plan["shared"] else state)
            assert 0 < plan["smem_bytes"] <= 232448
            assert plan["smem_bytes"] % 16 == 0
            if zt == compute:
                regs, warps, _ = occ()
                assert regs > 0 and warps >= plan["warps"], (kernel, d)
                shared = game.occupancy(kernel, entry,
                                        int(zt == torch.float64), *args, d,
                                        shared=True)[3]
                assert shared == plan["smem_bytes"], (kernel, d)
    if zt == torch.float32:
        assert game.stream_occupancy(1024, zt)[1] >= 16
    for fn in (lambda: game.stream_plan(512, zt),
               lambda: game.regret_plan(512, 2, zt),
               lambda: game.regret_plan(1024, 9, zt)):
        with pytest.raises(RuntimeError, match="plan failed"):
            fn()


# ------------------------------------ K3ew and K6bw: a sequence or a tail a warp

def _shifted(t):
    """A contiguous copy of ``t`` one element into its storage: a bf16
    tensor 2 bytes and an int8 one 1 byte off a 4-byte boundary, f32 4
    bytes and f64 8 bytes off a 16-byte one."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape)
    out.copy_(t)
    return out


K6BW_THS = np.array([0.3, -1.0, 0.05, 0.15, 1e30, 0.6, 0.1])


def _k3ew_k6bw_vs_plain(cuda, pair, d, T, contract, B=77, shift=False):
    """K3ew (eta 0.3 to 4.0 a sequence, so that rounds project) and K6bw
    (alone on the plain prefix's outputs, then K6 whole; eta = 4 and
    thresholds ``K6BW_THS`` times sqrt(2T), which switch at round 0, early,
    late and never) against their plain versions on the stored values in
    every bit, at B sequences with ragged lengths (zero rows past them on
    the packed API); each launch's state buffer is the one its plan asks
    for.  ``shift`` plays copies of the rows and labels that start one
    element into their storage (``_shifted``)."""
    z, y, lengths = _batch(B, T, d, seed=d + 41, contract=True)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    dtype = zf.dtype
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    assert game.in_contract(zs, ys, ln) == contract
    ths = torch.as_tensor(K6BW_THS * math.sqrt(2.0 * T), dtype=dtype,
                          device=cuda)
    G = ths.shape[0]
    assert game.wide_state_elems("K3e", B, d, 1, pair[0]) == (
        game.packed_plan(d, pair[0])["state"] * B)
    assert game.wide_state_elems("K6b", B, d, G, pair[0]) == (
        game.tail_plan(d, pair[0])["state"] * G * B)
    zk, yk = (_shifted(zs), _shifted(ys)) if shift else (zs, ys)
    before = (game.PACKED_ETA_LAUNCHES, smart.SWEEP_TAIL_LAUNCHES)
    part, tau, comp = smart.smart_prefix_reference(zf, yf, ths, ln,
                                                   replay=not contract)
    perm = torch.sort(ths, stable=True)[1].to(torch.int32)
    scales = game.sweep_scales(torch.tensor([4.0], dtype=dtype, device=cuda),
                               T)
    got = part.t().contiguous()
    smart.launch_smart_tails(zk, yk, scales, perm, game.length_order(ln), ln,
                             tau.t().contiguous(), comp, got)
    want = smart.smart_tails_reference(zf, yf, scales[0], ln, tau, part,
                                       comp)
    assert torch.equal(got.t(), want), ("K6bw", pair, d, contract)
    got = smart.smart_sweep(zk, yk, ths, 4.0, ln)
    want = smart.smart_sweep_reference(
        zf, yf, ths, torch.tensor(4.0, dtype=dtype, device=cuda), ln,
        replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (
        "K6", pair, d, contract)
    valid = (torch.arange(T, device=cuda)[None, :] < ln[:, None].long())
    z_tm, y_tm = game.time_major(torch.where(valid[..., None], zs, 0),
                                 torch.where(valid, ys, 0))
    zf_tm, yf_tm = game.time_major(torch.where(valid[..., None], zf, 0.0),
                                   torch.where(valid, yf, 0.0))
    if shift:
        z_tm, y_tm = _shifted(z_tm), _shifted(y_tm)
    eta = torch.linspace(0.3, 4.0, B, dtype=dtype, device=cuda)
    got = game.play_packed_eta(z_tm, y_tm, eta)
    want = game.play_packed_eta_reference(zf_tm, yf_tm, eta)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (
        "K3ew", pair, d, contract)
    torch.cuda.synchronize()
    assert (game.PACKED_ETA_LAUNCHES, smart.SWEEP_TAIL_LAUNCHES) == (
        before[0] + 1, before[1] + 2)
    return tau, ln


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("d", [513, 1024])
def test_k3ew_k6bw_equal_plain_in_every_pair(cuda, pair, d):
    """K3ew and K6bw equal their plain versions in every bit in every
    storage pair at d = 513 and 1,024, B = 77 (a multiple of no block's
    warps) and 48 (a full last block), contract and replay data, with
    tails from round 1 on, pairs that never switch and pairs whose switch
    leaves no tail."""
    for contract in (True, False):
        tau, ln = _k3ew_k6bw_vs_plain(cuda, pair, d, 12, contract)
        assert bool((tau == 0).any()) and bool((tau == 12).any())
        assert bool((tau + 1 >= ln[:, None].long()).any())
    _k3ew_k6bw_vs_plain(cuda, pair, d, 12, True, B=48)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("kernel", ["K3ew", "K6bw"])
def test_k3ew_k6bw_across_the_shared_boundary(cuda, pair, kernel):
    """At the largest d whose state fits a block's shared memory (K3ew's
    plan is K3w's) and one past it (the state buffer the plan asks for),
    each instance equals its plain version in every bit; its plan says
    which side it is on."""
    plan = game.packed_plan if kernel == "K3ew" else game.tail_plan
    boundary = plan(1024, pair[0])["max_shared_d"]
    for d, shared in ((boundary, True), (boundary + 1, False)):
        assert plan(d, pair[0])["shared"] == shared
        for contract in (True, False):
            _k3ew_k6bw_vs_plain(cuda, pair, d, 3, contract, B=21)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("shared", [True, False])
def test_k3ew_k6bw_read_offset_views(cuda, pair, shared):
    """K3ew and K6bw (and K6aw before it) on rows and labels that start
    one element into their storage (bf16 2 bytes off a 4-byte boundary)
    equal their plain versions in every bit, on both sides of each plan's
    shared boundary."""
    zt = pair[0]
    d = 513 if shared else max(game.packed_plan(1024, zt)["max_shared_d"],
                               game.tail_plan(1024, zt)["max_shared_d"]) + 1
    assert game.packed_plan(d, zt)["shared"] == shared
    assert game.tail_plan(d, zt)["shared"] == shared
    _k3ew_k6bw_vs_plain(cuda, pair, d, 5, True, B=21, shift=True)


@pytest.mark.parametrize("pair", ALL_PAIRS)
def test_k3ew_k6bw_plans_fit_a_block(cuda, pair):
    """K6bw's plan: a warp a tail, its group of 1-8 tails a block; state on
    the chip exactly up to max_shared_d (past the path's d = 1,024), a
    block within the H100's 227 KB, no buffer where shared and theta,
    padded to 4 elements, a (threshold, sequence) pair past it; the
    occupancy entries report the plans' blocks, K3ew's K3w's; at d = 1,024
    in f64 at least 8 tails an SM."""
    zt = pair[0]
    k6 = game.tail_plan(1024, zt)
    boundary = k6["max_shared_d"]
    assert 1 <= k6["warps"] <= 8 and 1024 < boundary < 65536
    lib = game.cuda_build.load()
    code = game.storage_code(zt)
    for d in (513, 1024, 2048, boundary, boundary + 1, 65536):
        plan = game.tail_plan(d, zt)
        assert plan["warps"] == k6["warps"]
        assert plan["shared"] == (d <= boundary), d
        assert plan["state"] == (0 if plan["shared"] else -(-d // 4) * 4)
        assert 0 < plan["smem_bytes"] <= 232448
        assert plan["smem_bytes"] % 16 == 0
        occ = game.occupancy("K6bw", lib.oco_smart_sweep_occupancy, code, 1,
                             d, shared=True)
        assert occ[0] > 0 and occ[1] >= plan["warps"], d
        assert occ[3] == plan["smem_bytes"], d
        occ = game.occupancy("K3ew", lib.oco_packed_occupancy, code, 1, d,
                             shared=True)
        assert occ[3] == game.packed_plan(d, zt)["smem_bytes"], d
    if zt == torch.float64:
        assert smart.sweep_occupancy(True, 1024, zt)[1] >= 8
    with pytest.raises(RuntimeError, match="plan failed"):
        game.tail_plan(512, zt)


# ------------------ K2w: K6aw's and K6bw's kernels in K2 mode, two launches

def _k2w_thresholds(T, B, dtype, cuda):
    """Four thresholds a sequence, spread over the sequences: two equal,
    one early, one out of reach, times sqrt(2T)."""
    spread = torch.linspace(0.5, 1.5, B, dtype=torch.float64, device=cuda)
    rows = torch.stack([0.05 * spread, 0.3 * spread, 0.3 * spread,
                        torch.full_like(spread, 1e30)])
    return (rows * math.sqrt(2.0 * T)).to(dtype)


def _k2w_vs_plain(cuda, pair, d, T, contract, B=77, shift=False):
    """K2w (``smart_plays`` past d = 512: its FTL launch, then its tails;
    four thresholds a sequence, two of them equal) against
    ``smart_plays_reference`` on the stored values in every bit (cum,
    comp, x_last, switch_t), B sequences with ragged lengths; a narrow
    pair also against the f32 launch on the upcast values.  ``shift``
    plays copies of the rows and labels that start one element into their
    storage (``_shifted``).  The state buffer is the one the two plans ask
    for.  Returns the switch rounds and the lengths."""
    z, y, lengths = _batch(B, T, d, seed=d + 43, contract=True)
    if not contract:
        z = 1.5 * z / np.maximum(1.0, np.linalg.norm(z, axis=-1,
                                                     keepdims=True))
    if pair[0] == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    dtype = zf.dtype
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    assert game.in_contract(zs, ys, ln) == contract
    ths = _k2w_thresholds(T, B, dtype, cuda)
    G = ths.shape[0]
    assert game.wide_state_elems("K2", B, d, G, pair[0]) == (
        game.plays_plan(d, pair[0], tails=False)["state"] * B
        + game.plays_plan(d, pair[0], tails=True)["state"] * G * B)
    zk, yk = (_shifted(zs), _shifted(ys)) if shift else (zs, ys)
    before = smart.LAUNCHES
    got = smart.smart_plays(zk, yk, ths, 1.3, ln, not contract)
    torch.cuda.synchronize()
    assert smart.LAUNCHES == before + 2
    eta = game.per_sequence(1.3, B, dtype, cuda)
    want = smart.smart_plays_reference(zf, yf, ths, eta, ln,
                                       replay=not contract)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (
        "K2w", pair, d, contract)
    if zs.dtype != zf.dtype or ys.dtype != yf.dtype:
        wide = smart.smart_plays(zf, yf, ths, 1.3, ln, not contract)
        assert all(torch.equal(g, w) for g, w in zip(got, wide)), (
            "K2w narrow", pair, d)
    return got[3], ln


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("d", [513, 1024])
def test_k2w_equals_plain_in_every_pair(cuda, pair, d):
    """K2w equals ``smart_plays_reference`` in every bit in every storage
    pair at d = 513 and 1,024, B = 77, contract and replay data, with
    switches at round 0, later and never, switches that leave no tail
    (the last valid round) and sequences of length 0; each narrow pair
    equals the f32 launch on the upcast values."""
    for contract in (True, False):
        tau, ln = _k2w_vs_plain(cuda, pair, d, 12, contract)
        ln = ln[None].long()
        assert bool((tau == 0).any()) and bool((tau == 12).any())
        assert bool(((tau < 12) & (tau + 1 >= ln)).any())


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("tails", [False, True])
def test_k2w_across_the_shared_boundary(cuda, pair, tails):
    """At the largest d whose state fits a block's shared memory in K2w's
    FTL launch (K6aw's boundary) or its tail launch, and one past it (the
    state buffer the plan asks for), K2w equals its plain version in every
    bit; the plan says which side it is on."""
    boundary = game.plays_plan(1024, pair[0], tails)["max_shared_d"]
    for d, shared in ((boundary, True), (boundary + 1, False)):
        assert game.plays_plan(d, pair[0], tails)["shared"] == shared
        for contract in (True, False):
            _k2w_vs_plain(cuda, pair, d, 3, contract, B=21)


@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("shared", [True, False])
def test_k2w_reads_offset_views(cuda, pair, shared):
    """K2w on rows and labels that start one element into their storage
    (bf16 and int8 off a 4-byte boundary, f32 and f64 off 16 bytes) equals
    its plain version in every bit, on both sides of its plans' shared
    boundaries."""
    zt = pair[0]
    d = 513 if shared else max(
        game.plays_plan(1024, zt, tails)["max_shared_d"]
        for tails in (False, True)) + 1
    for tails in (False, True):
        assert game.plays_plan(d, zt, tails)["shared"] == shared
    _k2w_vs_plain(cuda, pair, d, 5, True, B=21, shift=True)


@pytest.mark.parametrize("pair", ALL_PAIRS)
def test_k2w_plans_fit_a_block(cuda, pair):
    """K2w's FTL launch plans as K6aw does (its block, shared memory,
    boundary and state) for its own kernel; its tail launch plays a tail
    a block, state on the chip exactly up to its max_shared_d (past the
    path's d = 1,024), theta padded to 4 elements a pair past it; the
    occupancy entries report the plans' blocks (K2's own entry the FTL
    launch's past 512); at d = 1,024 in f64 both hold 8 warps an SM, so
    that the path's 1,024 sequences and 1,024 tails each run in one wave
    on 132 SMs."""
    zt = pair[0]
    compute = game.compute_dtype(zt)
    tail = game.plays_plan(1024, zt, True)
    boundary = tail["max_shared_d"]
    assert tail["warps"] == 1 and 1024 < boundary < 65536
    for d in (513, 1024, 2048, boundary, boundary + 1, 65536):
        ftl = game.plays_plan(d, zt, False)
        k6a = game.prefix_plan(d, zt)
        for key in ("shared", "state", "max_shared_d"):
            assert ftl[key] == k6a[key], (key, d)
        assert ftl["smem_bytes"] * k6a["warps"] == \
            k6a["smem_bytes"] * ftl["warps"], d
        plan = game.plays_plan(d, zt, True)
        assert plan["warps"] == 1
        assert plan["shared"] == (d <= boundary), d
        assert plan["state"] == (0 if plan["shared"] else -(-d // 4) * 4)
        assert 0 < plan["smem_bytes"] <= 232448
        assert plan["smem_bytes"] % 16 == 0
        for tails, p in ((False, ftl), (True, plan)):
            occ = smart.plays_occupancy(tails, d, zt)
            assert occ[0] > 0 and occ[1] >= p["warps"], (tails, d)
            assert occ[3] == p["smem_bytes"], (tails, d)
        if zt == compute:
            assert smart.smart_occupancy(2, d, compute) == \
                smart.plays_occupancy(False, d, zt)[:3]
    if zt == torch.float64:
        for tails in (False, True):
            assert smart.plays_occupancy(tails, 1024, zt)[1] >= 8
    for tails in (False, True):
        with pytest.raises(RuntimeError, match="plan failed"):
            game.plays_plan(512, zt, tails)


# ------------------------------- offset views through K5w, K6aw, thin narrow

@pytest.mark.parametrize("pair", ALL_PAIRS)
@pytest.mark.parametrize("shared", [True, False])
def test_k5w_k6aw_read_offset_views(cuda, pair, shared):
    """K5w (its 16-byte row copies where rows and z are 16-byte aligned,
    else the element path) and K6aw (staging from the row's 16-byte
    window) on rows and labels that start one element into their storage
    equal their plain versions in every bit, and K5w the launch on the
    aligned rows, at d = 1,024 (d times the element a multiple of 16
    bytes) and past K6aw's shared boundary."""
    zt = pair[0]
    d = 1024 if shared else game.prefix_plan(1024, zt)["max_shared_d"] + 1
    assert game.prefix_plan(d, zt)["shared"] == shared
    B, T = 21, 5
    z, y, lengths = _batch(B, T, d, seed=d + 43, contract=True)
    if zt == torch.float64:
        zs, ys = _to((z, y), cuda, torch.float64)
        zf, yf = zs, ys
    else:
        zs, ys, zf, yf = _stored(z, y, pair, cuda)
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    zk, yk = _shifted(zs), _shifted(ys)
    assert zk.data_ptr() % 16 != 0 and torch.equal(zk, zs)
    etas = torch.tensor([0.1, 1.3, 3.7], dtype=zf.dtype, device=cuda)
    got = game.eta_sweep(zk, yk, etas, ln)
    assert torch.equal(got, game.eta_sweep_reference(zf, yf, etas, ln))
    assert torch.equal(got, game.eta_sweep(zs, ys, etas, ln))
    ths = torch.as_tensor(K6BW_THS * math.sqrt(2.0 * T), dtype=zf.dtype,
                          device=cuda)
    ordered, perm = torch.sort(ths, stable=True)
    got = smart.launch_smart_prefix(zk, yk, ordered, perm.to(torch.int32),
                                    game.length_order(ln), ln, False)
    want = smart.smart_prefix_reference(zf, yf, ths, ln)
    assert all(torch.equal(g.t() if g.ndim == 2 else g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("pair", STORAGE_PAIRS)
@pytest.mark.parametrize("d", [5, 3, 65])
def test_narrow_thin_kernels_read_offset_views(cuda, pair, d):
    """K1-K6's thin instances on narrow rows and labels that start one
    element into their storage (bf16 2 bytes, int8 1 byte off a 4-byte
    boundary: the windows of ``oco_tiles.cuh`` and the time-major words)
    equal the float32 instance on the same values in every bit."""
    B, T = 150, 77
    z, y, lengths = _batch(B, T, d, seed=97 + d)
    zs, ys, zf, yf = _stored(z, y, pair, cuda)
    zk, yk = _shifted(zs), _shifted(ys)
    assert yk.data_ptr() % 4 != 0 and torch.equal(zk, zs)
    assert zk.data_ptr() % 4 == (2 if pair[0] == torch.bfloat16 else 0)
    ln = game.per_sequence(lengths, B, torch.int32, cuda)
    fl = game.per_sequence(np.arange(B) % 2, B, torch.int32, cuda)
    et = torch.linspace(0.3, 2.5, B, device=cuda)
    th = torch.linspace(0.5, 6.0, B, device=cuda)
    sc = game.ftrl_scales(T, 1.3, device=cuda)
    c0 = game.zero_stream_carry(B, d, device=cuda)
    grid = [0.5, 1.3, 2.0]
    z_tm, y_tm = (_shifted(t) for t in game.time_major(zs, ys))
    zf_tm, yf_tm = game.time_major(zf, yf)
    cases = [
        lambda a, b, a_tm, b_tm: game.regrets_fused(a, b, fl, et, ln),
        lambda a, b, a_tm, b_tm: smart.smart_regrets(a, b, th, 1.2, ln),
        lambda a, b, a_tm, b_tm: (game.eta_sweep(a, b, grid, ln),),
        lambda a, b, a_tm, b_tm: smart.smart_sweep(a, b, grid, 1.2, ln),
        lambda a, b, a_tm, b_tm: game.play_packed(a_tm, b_tm, sc),
        lambda a, b, a_tm, b_tm: game.play_packed_eta(a_tm, b_tm, et),
        lambda a, b, a_tm, b_tm: game.play_stream(a_tm, b_tm, et, 9, c0,
                                                  alg_flag=fl),
    ]
    for i, case in enumerate(cases):
        got = case(zk, yk, z_tm, y_tm)
        want = case(zf, yf, zf_tm, yf_tm)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (i, pair)


@pytest.mark.parametrize("d", [513, 1024])
def test_wide_sweep_identities(cuda, d):
    """f64: K5w's column e equals K1w with eta = eta_e; K6 with a threshold
    no pair reaches gives K1w's FTL regret with tau = T; K3w with
    ftrl_scales gives K1w's FTRL cum and K3ew K1w's with the same
    per-sequence eta, all in every bit."""
    B, T = 64, 48
    z, y, _ = _batch(B, T, d, seed=d + 5)
    zt, yt = _to((z, y), cuda, torch.float64)
    ln = torch.full((B,), T, dtype=torch.int32, device=cuda)
    etas = [0.2, 1.3, 2.9]
    sweep = game.eta_sweep(zt, yt, etas, ln)
    for e, eta in enumerate(etas):
        cum, comp, _ = game.regrets_fused(zt, yt, 0, eta)
        assert torch.equal(sweep[:, e], cum - comp)
    regret, tau = smart.smart_sweep(zt, yt, [1e30], 1.3, ln)
    cum, comp, _ = game.regrets_fused(zt, yt, 1, 1.3)
    assert torch.equal(regret[:, 0], cum - comp) and bool((tau == T).all())
    z_tm, y_tm = game.time_major(zt, yt)
    cum, _ = game.play_packed(z_tm, y_tm, game.ftrl_scales(
        T, 1.3, dtype=torch.float64, device=cuda))
    assert torch.equal(cum, game.regrets_fused(zt, yt, 0, 1.3)[0])
    per_seq = torch.linspace(0.3, 2.5, B, dtype=torch.float64, device=cuda)
    cum, _ = game.play_packed_eta(z_tm, y_tm, per_seq)
    assert torch.equal(cum, game.regrets_fused(zt, yt, 0, per_seq)[0])


def test_wide_sweep_entry_points_on_the_card(cuda):
    """The entry points a user calls take d = 513 on the card through K5w,
    K6aw, K6bw, K3w, K3ew and K7w (their counters rise), within 1e-9 of
    their CPU runs in f64 (K7, float32 only, equal to its plain version on
    the card)."""
    from online_convex_optimization_tpu_torch.models.sweep_api import (
        ftrl_eta_sweep, smart_threshold_sweep)
    B, T, d = 16, 24, 513
    z, y, lengths = _batch(B, T, d, seed=6)
    counters = ((game, "SWEEP_LAUNCHES"), (smart, "SWEEP_LAUNCHES"),
                (smart, "SWEEP_TAIL_LAUNCHES"), (game, "PACKED_LAUNCHES"),
                (game, "PACKED_ETA_LAUNCHES"))
    before = [getattr(m, n) for m, n in counters]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        zt, yt = _to((z, y), dev, torch.float64)
        eta = torch.linspace(0.3, 2.5, B, dtype=torch.float64, device=dev)
        outs[dev.type] = (
            ftrl_eta_sweep(zt, yt, [0.5, 1.3], length=lengths),
            smart_threshold_sweep(zt, yt, [1.0, 3.0], eta0=1.3,
                                  length=lengths),
            game.simulate_linear_packed(zt, yt, 1, 1.3),
            game.simulate_linear_packed(zt, yt, 0, eta))
    torch.cuda.synchronize()
    assert [getattr(m, n) for m, n in counters] == [
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1,
        before[4] + 1]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _max_err((got.cpu(),), (want,)) <= TOL[torch.float64]
    before = game.SYNTHETIC_LAUNCHES
    got = game.synthetic_regrets(4, 1.3, T=T, lane_batch=2, d=d)
    assert game.SYNTHETIC_LAUNCHES == before + 1
    assert torch.equal(got, game.synthetic_regrets_reference(
        4, 1.3, T=T, lane_batch=2, d=d, device=cuda))


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
    8,192 entries four a block and the eight longer ones two a block: four
    launches, two of them K10l's, both resident; every row within 5e-4 of
    the plain version, at the d = 5 instance and the generic one."""
    z, y = _admm_batch(1, 8200, d, seed=50 + d, cuda=cuda)
    kw = dict(iters=100, tol=tol, check_every=50)
    before = (admm.LAUNCHES, admm.LONG_LAUNCHES, admm.RESIDENT_LAUNCHES,
              admm.RESIDENT_LONG_LAUNCHES)
    X, res, state = admm.admm_all_prefixes_l2(z, y, **kw)
    torch.cuda.synchronize()
    assert admm.kernel_instances(8200) == ["resident_long", "resident", 16,
                                           8]
    assert (admm.LAUNCHES - before[0], admm.LONG_LAUNCHES - before[1],
            admm.RESIDENT_LAUNCHES - before[2],
            admm.RESIDENT_LONG_LAUNCHES - before[3]) == (4, 2, 2, 1)
    res_p, state_p = admm.admm_all_prefixes_l2_reference(
        z, y, admm.admm_prologue(z), rho=1.0, alpha=1.7, **kw)
    assert _max_err(state, state_p) <= TOL[torch.float32]
    assert _max_err((res.reshape(-1),), (res_p,)) <= TOL[torch.float32]
    occ = admm.kernel_occupancy(8200, d)
    assert occ["resident_one"][1] == 0 and occ["long"][1] == 0
    for name in ("resident", "resident_long"):
        assert occ[name][1] == 8 * admm.resident_plan(d, name)["groups"]


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


@pytest.mark.parametrize("d", [5, 8])
def test_resident_long_plan_fits_a_block(cuda, d):
    """K10l's two-row resident shape as its source sizes it: two rows in
    two groups of 256 threads, 64 entries a thread a row, the same 16 of a
    thread's 64 in registers and 48 in shared memory as the four-row shape,
    its ring as deep, within a block's 227 KB; rows of 8,193 to 16,384
    entries."""
    short, plan = admm.resident_plan(d), admm.resident_plan(d,
                                                            "resident_long")
    assert (plan["rows"], plan["groups"], plan["group_rows"],
            plan["threads"], plan["entries"], plan["register_entries"],
            plan["shared_entries"]) == (2, 2, 1, 512, 64, 16, 48)
    assert (plan["lo"], plan["hi"]) == (admm.RESIDENT_ROWS,
                                        admm.RESIDENT_LONG_ROWS)
    assert (short["lo"], short["hi"]) == (admm.LONG_ROWS, admm.RESIDENT_ROWS)
    assert plan["stages"] == short["stages"]
    assert plan["smem_bytes"] == short["smem_bytes"]
    assert plan["static_bytes"] < short["static_bytes"]
    assert plan["smem_bytes"] + plan["static_bytes"] <= trs.H100_SMEM_OPTIN


@functools.lru_cache(maxsize=None)
def _k10l_stream_route():
    """K10's sources built with -DOCO_ADMM_SPLIT and routed so that every
    row past 4,096 entries takes K10l's streaming instance
    (``scripts/wide_probe.py``'s probe build, once a process)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "wide_probe.py")
    spec = importlib.util.spec_from_file_location("wide_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    so = probe.k10l_split_library()
    so.oco_admm_split_route(1)
    return so


def _k10l_outputs(T, d, cuda):
    return [torch.empty((T, T), device=cuda) for _ in range(2)] + \
        [torch.empty((T, d), device=cuda) for _ in range(3)] + \
        [torch.empty(T, device=cuda)]


def _k10l_probe_launch(so, z, y, Lpk, outs, iters, tol, state0=None):
    """One launch of the probe build's C entry on (1, T, d); its counts."""
    import ctypes
    _, T, d = z.shape
    launched = (ctypes.c_int * 6)()
    ptrs0 = [a.data_ptr() for a in state0] if state0 else [None] * 5
    assert so.oco_admm_all_prefixes_f32(
        z.data_ptr(), y.data_ptr(), Lpk.data_ptr(), *ptrs0, 1, T, d, iters,
        100, tol, 0.5, 1.7, 1.0 - 1.7, *(a.data_ptr() for a in outs),
        torch.cuda.current_stream().cuda_stream, launched) == 0
    return list(launched)


@pytest.mark.parametrize("T,instances,tol", [
    (9216, ["resident_long", "resident", 16, 8], 0.0),
    (20480, ["resident_one", "resident_long", "resident", 16, 8], 0.0),
    (20480, ["resident_one", "resident_long", "resident", 16, 8], 2e-4),
    (36864, ["resident_one", "resident_long", "resident", 16, 8], 0.0),
    (38944, ["long", "resident_one", "resident_long", "resident", 16, 8],
     0.0),
    (38944, ["long", "resident_one", "resident_long", "resident", 16, 8],
     2e-4)])
def test_k10l_rows_past_8192_equal_the_streaming_route(cuda, T, instances,
                                                       tol):
    """The rows of 8,193 to 16,384 entries on the two-row resident shape,
    and at T = 20,480, 36,864 and 38,944 those of 16,385 to 38,912 on the
    one-row block (at T = 38,944 the 32 longer rows on the streaming
    instance), equal the launch that streams every long row (the probe
    build's route, the design before the resident shapes) in every output
    bit, d = 5, 200 iterations, fixed and at the route's tol."""
    so = _k10l_stream_route()
    so.oco_admm_split_route(1)
    z, y = _admm_batch(1, T, 5, seed=61, cuda=cuda)
    Lpk = admm.admm_prologue(z)
    outs = _k10l_outputs(T, 5, cuda)
    assert _k10l_probe_launch(so, z, y, Lpk, outs, 200, tol) == \
        [3, 1, 0, 0, 0, 0]
    before = (admm.LONG_LAUNCHES, admm.RESIDENT_LAUNCHES,
              admm.RESIDENT_LONG_LAUNCHES, admm.RESIDENT_ONE_LAUNCHES)
    res, st = admm.launch_admm(z, y, Lpk, iters=200, tol=tol,
                               check_every=100, rho=1.0, alpha=1.7)
    torch.cuda.synchronize()
    assert admm.kernel_instances(T) == instances
    assert (admm.LONG_LAUNCHES - before[0], admm.RESIDENT_LAUNCHES - before[1],
            admm.RESIDENT_LONG_LAUNCHES - before[2],
            admm.RESIDENT_ONE_LAUNCHES - before[3]) == (
        len(instances) - 2, 2, 1, int("resident_one" in instances))
    assert all(torch.equal(a, b) for a, b in zip(outs, (*st, res)))


@pytest.mark.parametrize("route,tol", [(2, 0.0), (2, 2e-4), (3, 0.0),
                                       (3, 2e-4)])
def test_k10l_cluster_designs_equal_the_streaming_route(cuda, route, tol):
    """The probe build's thread-block cluster (route 2: design (a), the
    first block computing; route 3: design (b), the partial sums handed
    block to block) on the rows past the one-row block's 38,912 entries at
    T = 38,944, with the one-row block below, equals the route that streams
    every long row in every output bit, d = 5, 200 iterations fixed and at
    the route's tol; its launch counts one cluster launch, and 100 + 100
    iterations from the saved state equal 200 on it."""
    so = _k10l_stream_route()
    T = 38944
    z, y = _admm_batch(1, T, 5, seed=62, cuda=cuda)
    Lpk = admm.admm_prologue(z)
    ref = _k10l_outputs(T, 5, cuda)
    so.oco_admm_split_route(1)
    _k10l_probe_launch(so, z, y, Lpk, ref, 200, tol)
    got = _k10l_outputs(T, 5, cuda)
    try:
        so.oco_admm_split_route(route)
        assert _k10l_probe_launch(so, z, y, Lpk, got, 200, tol) == \
            [6, 4, 2, 1, 1, 1]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        if tol == 0.0:
            half = _k10l_outputs(T, 5, cuda)
            _k10l_probe_launch(so, z, y, Lpk, half, 100, tol)
            _k10l_probe_launch(so, z, y, Lpk, got, 100, tol, half[:5])
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    finally:
        so.oco_admm_split_route(1)


@pytest.mark.parametrize("T,d", [(16500, 5), (16500, 8), (32900, 3)])
def test_k10l_past_16384_match_plain_and_continue(cuda, T, d):
    """The one-row block (rows of 16,385 to 38,912 entries), at the d = 5
    instance and the generic one: every row within 5e-4 of the plain
    version at 40 fixed iterations, one launch of the block, and 20 + 20
    iterations from the saved state equal 40 in every bit."""
    z, y = _admm_batch(1, T, d, seed=70 + d, cuda=cuda)
    before = admm.RESIDENT_ONE_LAUNCHES
    X, res, st = admm.admm_all_prefixes_l2(z, y, iters=40, tol=0.0)
    torch.cuda.synchronize()
    assert admm.RESIDENT_ONE_LAUNCHES == before + 1
    assert "resident_one" in admm.kernel_instances(T)
    res_p, st_p = admm.admm_all_prefixes_l2_reference(
        z, y, admm.admm_prologue(z), iters=40, tol=0.0, check_every=100,
        rho=1.0, alpha=1.7)
    assert _max_err(st, st_p) <= TOL[torch.float32]
    assert _max_err((res.reshape(-1),), (res_p,)) <= TOL[torch.float32]
    del st_p, res_p
    torch.cuda.empty_cache()
    _, _, st1 = admm.admm_all_prefixes_l2(z, y, iters=20, tol=0.0)
    Xc, rc, stc = admm.admm_all_prefixes_l2(z, y, iters=20, tol=0.0,
                                            state0=st1)
    assert torch.equal(Xc, X) and torch.equal(rc, res)
    assert all(torch.equal(a, b) for a, b in zip(stc, st))


@pytest.mark.parametrize("d", [5, 8])
def test_k10l_row_plan_matches_occupancy(cuda, d):
    """K10l's one-row block as the source sizes it (``admm.row_plan``) and
    as the occupancy API reports it: 256 threads, 64 + 88 entries a
    thread, one block of 8 warps an SM, its shared memory within a block's
    227 KB, rows of 16,385 to 38,912 entries; the streaming instance on the
    longer rows; no plan outside that range."""
    for L in (16385, 20000, 38912):
        plan = admm.row_plan(d, L)
        assert (plan["cluster"], plan["threads"], plan["entries"],
                plan["register_entries"], plan["shared_entries"],
                plan["lo"], plan["hi"]) == (
            1, 256, 152, 64, 88, admm.RESIDENT_LONG_ROWS,
            admm.RESIDENT_ONE_ROWS)
        assert plan["smem_bytes"] + plan["static_bytes"] <= \
            trs.H100_SMEM_OPTIN
        assert plan["stages"] >= 4
    occ = admm.kernel_occupancy(40000, d)
    assert occ["resident_one"][1] == 8 and occ["long"][1] > 0
    assert admm.kernel_occupancy(36864, d)["long"][1] == 0
    for L in (admm.RESIDENT_LONG_ROWS, admm.RESIDENT_ONE_ROWS + 1):
        with pytest.raises(RuntimeError):
            admm.row_plan(d, L)


@pytest.mark.parametrize("tol", [0.0, 2e-4])
def test_admm_long_instances_keep_the_identities(cuda, tol):
    """Rows p < T' of a T = 8,200 launch equal the launch on z[:, :T'] in
    every bit, for T' = 8,192 (no rows of the two-row shape) and 4,203
    (the four-row shape's rows in other row slots); 50 + 50 iterations
    equal 100; a replicate alone equals its rows in the batch."""
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
