"""The plain PyTorch versions of kernels K1 and K2 against the JAX package.

Two references on the same NumPy inputs:

- the JAX Pallas kernels in interpret mode (``regrets_fused``,
  ``smart_regrets_packed`` on ``pack_sequences`` layouts), float32, T <= 64,
  atol 5e-4 as tests/test_pallas_game_v2.py holds them;
- the JAX scans ``simulate_linear_batch`` / ``simulate_smart_batch`` in
  x64 with mixed flags, two thresholds and ragged lengths, bound 1e-9,
  switch rounds equal; also on data outside the identity contract (rows with
  ||z|| > 1, real-valued labels), where the port replays the comparator.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_convex_optimization_tpu.models.linear import (
    simulate_linear_batch as jax_linear_batch,
)
from online_convex_optimization_tpu.models.smart import (
    simulate_smart_batch as jax_smart_batch,
)
from online_convex_optimization_tpu.ops.pallas_game import (
    SEQ_TILE,
    pack_per_seq,
    pack_sequences,
    regrets_fused as jax_regrets_fused,
    unpack_result,
)
from online_convex_optimization_tpu.ops.pallas_smart import smart_regrets_packed
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.testing.from_jax import to_torch

torch.set_num_threads(1)

X64_TOL = 1e-9
F32_TOL = 5e-4


def _batch(B, T, d=5, seed=0, *, contract=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        z *= 1.5                                 # many rows with ||z|| > 1
        y = rng.normal(size=(B, T))              # real-valued labels
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return z, y, lengths


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


# ------------------------------------------------ JAX kernels, interpret mode

@pytest.mark.parametrize("alg_flag", [0, 1])
def test_regret_plain_matches_jax_kernel_interpret(alg_flag):
    z, y, _ = _batch(SEQ_TILE, 32, seed=11)
    z, y = z.astype(np.float32), y.astype(np.float32)
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    want = np.asarray(unpack_result(
        jax_regrets_fused(z_pack, y_pack, 1.3, alg_flag=alg_flag,
                          interpret=True), B))
    zt, yt = to_torch((z, y), "cpu")
    cum, comp, _ = game.regrets_fused(zt, yt, alg_flag, 1.3)
    _close(cum - comp, want, F32_TOL)


def test_smart_plain_matches_jax_kernel_interpret():
    z, y, _ = _batch(SEQ_TILE, 48, seed=1)
    z, y = z.astype(np.float32), y.astype(np.float32)
    thresh = np.where(np.arange(SEQ_TILE) % 2 == 0, 2.0, 0.75).astype(np.float32)
    eta = np.full(SEQ_TILE, math.sqrt(2.0), np.float32)
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    S = z_pack.shape[2]
    reg, tau = smart_regrets_packed(
        z_pack, y_pack, pack_per_seq(jnp.asarray(thresh), S),
        pack_per_seq(jnp.asarray(eta), S), interpret=True)
    zt, yt, th, et = to_torch((z, y, thresh, eta), "cpu")
    cum, comp, _, switch_t = smart.smart_regrets(zt, yt, th, et)
    _close(cum - comp, np.asarray(unpack_result(reg, B)), F32_TOL)
    np.testing.assert_array_equal(switch_t.numpy(),
                                  np.asarray(unpack_result(tau, B)))


# ------------------------------------------------------ JAX scans in x64

@pytest.mark.parametrize("d,contract", [(5, True), (3, True), (5, False)])
def test_regret_plain_matches_jax_scan_x64(d, contract):
    z, y, lengths = _batch(96, 80, d, seed=d, contract=contract)
    flags = (np.arange(96) % 2).astype(np.int32)
    eta = np.linspace(0.3, 2.5, 96)
    want = jax_linear_batch(jnp.asarray(z), jnp.asarray(y), jnp.asarray(flags),
                            jnp.asarray(eta), jnp.asarray(lengths))
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    assert game.in_contract(zt, yt, torch.as_tensor(lengths)) == contract
    cum, comp, x_last = game.regrets_fused(zt, yt, flags, eta, lengths)
    _close(cum, want.cum_loss, X64_TOL)
    _close(comp, want.comp_loss, X64_TOL)
    _close(cum - comp, want.regret, X64_TOL)
    _close(x_last, want.x_last, X64_TOL)


@pytest.mark.parametrize("d,contract", [(5, True), (3, True), (5, False)])
def test_smart_plain_matches_jax_scan_x64(d, contract):
    z, y, lengths = _batch(96, 80, d, seed=10 + d, contract=contract)
    thresh = np.where(np.arange(96) % 2 == 0, np.sqrt(2.0 * lengths), 1.75)
    eta = np.full(96, math.sqrt(2.0))
    want = jax_smart_batch(jnp.asarray(z), jnp.asarray(y), jnp.asarray(thresh),
                           jnp.asarray(eta), jnp.asarray(lengths))
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    cum, comp, x_last, switch_t = smart.smart_regrets(zt, yt, thresh, eta,
                                                      lengths)
    _close(cum, want.cum_loss, X64_TOL)
    _close(comp, want.comp_loss, X64_TOL)
    _close(cum - comp, want.regret, X64_TOL)
    _close(x_last, want.x_last, X64_TOL)
    np.testing.assert_array_equal(switch_t.numpy(), np.asarray(want.switch_t))
    assert (switch_t < 80).any() and (switch_t == 80).any()


@pytest.mark.parametrize("kernel", ["regret", "smart"])
def test_identity_and_replay_agree_on_contract_data(kernel):
    z, y, lengths = _batch(64, 70, seed=21)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    ln = torch.as_tensor(lengths, dtype=torch.int32)
    eta = torch.full((64,), 1.1, dtype=torch.float64)
    if kernel == "regret":
        flags = torch.arange(64) % 2
        run = lambda replay: game.regrets_fused_reference(
            zt, yt, flags, eta, ln, replay=replay)
    else:
        th = torch.full((64,), 2.5, dtype=torch.float64)
        run = lambda replay: smart.smart_regrets_reference(
            zt, yt, th, eta, ln, replay=replay)
    ident, replay = run(False), run(True)
    _close(ident[1], replay[1].numpy(), 1e-12)
    assert torch.equal(ident[0], replay[0])


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    import shutil

    from online_convex_optimization_tpu_torch.utils import cuda_build

    lib = tmp_path / "liboco_torch_kernels.so"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "LIB_PATH", str(lib))
    monkeypatch.setattr(cuda_build, "LOG_PATH", str(tmp_path / "build.log"))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build()
    assert not lib.exists()


def test_wrappers_reject_bad_inputs():
    z = torch.zeros((2, 4, 5), dtype=torch.float64)
    y = torch.ones((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        game.regrets_fused(z, y, 0, 1.0, [5, 4])           # length > T
    with pytest.raises(TypeError):
        game.regrets_fused(z, y.float(), 0, 1.0)            # mixed dtypes
    # The plain versions take any d, as every kernel does on the card (its
    # wide instance past 512): no wrapper refuses d = 513.
    z = torch.zeros((2, 4, 513), dtype=torch.float64)
    assert bool(torch.isfinite(smart.smart_regrets(z, y, 1.0, 1.0)[0]).all())
    assert bool(torch.isfinite(game.eta_sweep(z, y, [0.5, 1.0])).all())
    assert bool(torch.isfinite(smart.smart_sweep(z, y, [1.0], 1.0)[0]).all())
