"""The wide trust-region solve's host-side arithmetic and the premises of
its schedule (K9w and K8w, ``csrc/oco_trs.cuh`` ``oco::wide``).

- ``ops/trs.py``'s layout arithmetic, which the wrappers hold the card's
  launch plan to: a warp's workspace is one packed triangle of order d + 1
  (A's rows and b, the factor and v) and five vectors, each part padded to
  16 bytes; K8w's statistics are A's rows and b a warp in the scratch
  buffer; the largest d whose workspace fits a block's shared memory; the
  warps an SM holds by shared memory.
- Plain mirrors of the kernels' order, held bit for bit against the plain
  version (``_chol_factor``, ``_fwd_solve``, ``_bwd_solve``): the
  Cholesky by panels of four columns with the trailing triangle updated by
  a panel at once, on the triangle augmented by b, whose last row so
  becomes L^{-1} b; the forward substitution's owner-row chain; the
  backward substitution's products formed first and subtracted in
  increasing k with a zero product past d.

CPU only; no JAX reference (the JAX package has no wide instance of its
own: ``test_torch_quadratic.py`` holds the plain version at d = 40 against
it).
"""

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.ops import trs

DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_layout_pads_each_part_to_16_bytes(dtype):
    item = 4 if dtype == torch.float32 else 8
    for d in (33, 40, 64, 65, 127, 128, 255, 256, 334):
        lay = trs.wide_layout(d, dtype)
        for key, n in (("tri", (d + 1) * (d + 2) // 2),
                       ("stats", d * (d + 3) // 2)):
            assert 0 <= lay[key] - n < 16 // item
            assert lay[key] * item % 16 == 0
        # The statistics fill the triangle's rows in its order.
        assert lay["stats"] <= lay["tri"]
        vec = lay["work"] - lay["tri"]
        assert vec >= 5 * d and vec - 5 * d < 16 // item
        assert vec * item % 16 == 0
        assert lay["bytes"] == lay["work"] * item
    tri = 2148 if dtype == torch.float32 else 2146
    assert trs.wide_layout(64, dtype) == {"tri": tri, "stats": 2144,
                                          "work": tri + 320,
                                          "bytes": (tri + 320) * item}


@pytest.mark.parametrize("dtype,edge", [(torch.float32, 334),
                                        (torch.float64, 234)])
def test_wide_shared_boundary(dtype, edge):
    """The largest d whose workspace fits a block's 227 KB on an H100."""
    assert trs.wide_shared_max_d(dtype) == edge
    assert trs.wide_layout(edge, dtype)["bytes"] <= trs.H100_SMEM_OPTIN
    assert trs.wide_layout(edge + 1, dtype)["bytes"] > trs.H100_SMEM_OPTIN
    # One such block still fits an SM with its reservation.
    assert _warps_per_sm(edge, dtype) == 1
    # A smaller opt-in limit moves the boundary down.
    assert trs.wide_shared_max_d(dtype, optin=48 * 1024) < edge


def _warps_per_sm(d, dtype):
    """One-warp blocks an H100 SM holds by shared memory alone: its 233,472
    bytes over a workspace and the 1,024 each block reserves, at most 32."""
    return min(32, 233472 // (trs.wide_layout(d, dtype)["bytes"] + 1024))


@pytest.mark.parametrize("dtype,warps", [
    (torch.float32, {64: 21, 128: 6, 33: 32}),
    (torch.float64, {64: 11, 128: 3, 33: 32})])
def test_wide_warps_per_sm(dtype, warps):
    """One triangle a warp: 21 warps an SM at d = 64 in float32 (12 with
    two, A's and the factor's), 11 in float64 (6); 6 and 3 at d = 128 (3
    and 1)."""
    for d, want in warps.items():
        assert _warps_per_sm(d, dtype) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_scratch_elems(dtype):
    """K9w needs scratch only for workspaces past shared memory; K8w also
    a statistics slice a warp."""
    lay = trs.wide_layout(64, dtype)
    assert trs.wide_scratch_elems("K9w", 64, dtype, 2772, True) == 0
    assert trs.wide_scratch_elems("K9w", 64, dtype, 10, False) == \
        10 * lay["work"]
    assert trs.wide_scratch_elems("K8w", 64, dtype, 2772, True) == \
        2772 * lay["stats"]
    assert trs.wide_scratch_elems("K8w", 64, dtype, 10, False) == \
        10 * (lay["stats"] + lay["work"])
    # K8w's statistics at the d = 64 bench shape, B = 4,096 sequences on
    # one wave of 21 x 132 warps: 2,772 slices, 24 MB in float32.
    assert trs.wide_scratch_elems("K8w", 64, torch.float32, 2772, True) \
        * 4 == 23772672


def test_wide_max_d_keeps_offsets_32_bit():
    for dtype in DTYPES:
        assert trs.wide_layout(trs.WIDE_MAX_D, dtype)["work"] < 2 ** 32
    # Row starts r_i = i (i + 1) / 2 are formed in 32 bits for i < d.
    i = trs.WIDE_MAX_D
    assert i * (i + 1) < 2 ** 32
    trs.check_wide_d(trs.WIDE_MAX_D)
    with pytest.raises(ValueError, match="32-bit"):
        trs.check_wide_d(trs.WIDE_MAX_D + 1)


# ------------------------------------------------- the schedule's premises

def _problems(d, n_rows, dtype, seed):
    """Packed prefix Gram matrices of n_rows rows (singular below d) and
    b, a batch of 6, as the plain version takes them."""
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.normal(size=(6, n_rows, d)), dtype=dtype)
    y = torch.as_tensor(rng.normal(size=(6, n_rows)), dtype=dtype)
    A = torch.zeros((6, d, d), dtype=dtype)
    b = torch.zeros((6, d), dtype=dtype)
    for t in range(n_rows):
        A = A + z[:, t, :, None] * z[:, t, None, :]
        b = b + y[:, t, None] * z[:, t]
    rows, cols = trs.tri_index(d)
    return A[:, rows, cols].t().contiguous(), [b[:, i] for i in range(d)]


def _tri(i, j):
    return i * (i + 1) // 2 + j


def _panel_chol(A, lam, d, panel=4, rows=None):
    """The kernel's Cholesky order over d columns of a packed triangle of
    ``rows`` rows (d, or d + 1 with b as the last): panels of ``panel``
    columns, each column's pivot, divides and the panel's own updates, then
    the trailing triangle by the panel's columns at once (entry by entry,
    in increasing j)."""
    rows = rows or d
    L = A.clone()
    for i in range(d):
        L[_tri(i, i)] = L[_tri(i, i)] + lam
    for j0 in range(0, d, panel):
        jn = min(j0 + panel, d)
        for j in range(j0, jn):
            piv = trs.correctly_rounded_sqrt(L[_tri(j, j)])
            for i in range(j + 1, rows):
                L[_tri(i, j)] = L[_tri(i, j)] / piv
            L[_tri(j, j)] = piv
            for m in range(j + 1, jn):
                for i in range(m, rows):
                    L[_tri(i, m)] = L[_tri(i, m)] - L[_tri(i, j)] * \
                        L[_tri(m, j)]
        for m in range(jn, d):
            for i in range(m, rows):
                c = L[_tri(i, m)]
                for j in range(j0, jn):
                    c = c - L[_tri(i, j)] * L[_tri(m, j)]
                L[_tri(i, m)] = c
    return L


def _owner_fwd(L, b, d):
    """The kernel's forward substitution: v_k on its owner, then every
    row's subtraction of L_ik v_k, the next pivot row's first."""
    acc = [bi.clone() for bi in b]
    v = [None] * d
    for k in range(d):
        v[k] = acc[k] / L[_tri(k, k)]
        for i in range(k + 1, d):
            acc[i] = acc[i] - L[_tri(i, k)] * v[k]
    return v


def _shuffled_bwd(L, v, d):
    """The kernel's backward substitution: the products L_ki x_k formed
    first, 32 a chunk with +0 past d, then subtracted in increasing k, 16
    at a time."""
    x = [None] * d
    for i in reversed(range(d)):
        s = v[i]
        for k0 in range(i + 1, d, 32):
            p = [L[_tri(k, i)] * x[k] if k < d else torch.zeros_like(s)
                 for k in range(k0, k0 + 32)]
            for t in range(-(-min(32, d - k0) // 16) * 16):
                s = s - p[t]
        x[i] = s / L[_tri(i, i)]
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,n_rows", [(9, 5), (13, 40), (37, 30), (6, 6)])
def test_panel_cholesky_order_is_the_plain_order(dtype, d, n_rows):
    A, b = _problems(d, n_rows, dtype, seed=d + n_rows)
    lam = torch.full((6,), 1e-3, dtype=dtype)
    want = trs._chol_factor(A, lam, d)
    v = trs._fwd_solve(want, b, d)
    # The kernel's triangle: A's rows, then b as row d (its diagonal slot
    # unused), factored over d columns.
    aug = torch.cat([A, torch.stack(b), torch.zeros_like(A[:1])])
    got = _panel_chol(aug, lam, d, rows=d + 1)
    assert torch.equal(got[:_tri(d, 0)], want)
    assert torch.equal(got[_tri(d, 0):_tri(d, d)], torch.stack(v))
    # The substitutions' orders on that factor.
    assert all(torch.equal(g, w) for g, w in zip(_owner_fwd(want, b, d), v))
    x = trs._bwd_solve(want, v, d)
    assert all(torch.equal(g, w) for g, w in zip(_shuffled_bwd(want, v, d),
                                                 x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_subtracting_a_zero_product_keeps_every_bit(dtype):
    """s - (+0) is s in every bit (-0, infinities and NaN included): the
    backward substitution's chunks past d subtract +0."""
    rng = np.random.default_rng(3)
    s = torch.as_tensor(np.concatenate([
        rng.normal(size=64) * 10.0 ** rng.integers(-30, 30, size=64),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-310]]), dtype=dtype)
    itype = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal((s - torch.zeros_like(s)).view(itype), s.view(itype))
