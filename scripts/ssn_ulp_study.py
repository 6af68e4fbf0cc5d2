#!/usr/bin/env python3
"""How far one-ulp changes of z move the semismooth Newton (SSN), in the
port and in the JAX package, on the two instances where the port's tests
exempt a prefix shorter than or equal to d.  CPU only, float64, like the
tests that hold the two packages against each other.

    JAX_PLATFORMS=cpu python3 scripts/ssn_ulp_study.py [--changes N] [--steps]

(``--steps``: the step counts of part 4 alone.)

Every change moves one entry z[t, j] with t < d (a row of the prefixes
in question) by one ulp, (t, j) from a seeded generator, up and down in
turn.

1. ``tests/test_torch_ssn.py``'s fuzz instance of seed 7 (T = 86, d = 5):
   its prefix of length d stops at a fixed point at the continuation floor
   (mu = 1e-6), whose duality gap depends on the iterate's last bits.  For
   N one-ulp changes of z (default 24) both packages solve every
   prefix (2,000 steps, tol 1e-5; the port's runs as the members of one
   batch, as the test's fixture solves, JAX's one by one), and
   the script prints the certified gap of that prefix (``res[d - 1]``) on
   the unchanged z and over the changes: how many stay above 1e-5, and the
   smallest and largest gap.
2. ``tests/test_torch_cuda.py::test_ssn_on_the_card_matches_cpu``'s
   instance (B = 2, T = 60, d = 5, seed 0): the port at 10 fixed steps on
   the CPU, and the largest change of each prefix objective under 12
   one-ulp changes of z, relative to 1 + f, for the prefixes shorter than
   d and for the others.
3. The same test's pipeline cut (``evaluate_stream_exact`` on "Random
   i.i.d. (separable)", T_grid [40, 60], one run, two replicates, solver
   "ssn", on the CPU): the exact-FTL regret statistic, and how far it
   moves when the SSN's input z (not the scored data) changes by one ulp
   (12 changes), beside the largest change of a polished action on the
   prefixes of at least d rows.
4. The Newton steps each member of the card test's instance takes to
   reach its converged runs' tol (2e-4) from the cold start, in the port
   (``counts``) and in JAX (one step a call from the carried state, which
   the iteration is Markov in, until every row's gap is at or below tol).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from online_convex_optimization_tpu.models import ssn as jax_ssn  # noqa: E402
from online_convex_optimization_tpu_torch.models import ssn  # noqa: E402

D = 5


def fuzz_instance(seed):
    """``tests/test_torch_ssn.py::_fuzz_instance``."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(20, 90))
    scale = float(rng.uniform(0.5, 4.0))
    z = scale * rng.normal(size=(T, D))
    y = np.sign(z @ rng.normal(size=D)
                + rng.uniform(0, 0.8) * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


def ulp_entries(n, seed):
    """n (t, j, direction) with t < D: the entries the changes move."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, D)), int(rng.integers(0, D)),
             1.0 if k % 2 else -1.0) for k in range(n)]


def one_ulp_changes(z, n, seed):
    """z and n copies, each with one entry z[..., t, j], t < D, moved by
    one ulp; (n + 1, *z.shape)."""
    out = np.repeat(z[None], n + 1, axis=0)
    for k, (t, j, s) in enumerate(ulp_entries(n, seed)):
        out[k + 1, ..., t, j] = np.nextafter(out[k + 1, ..., t, j],
                                             s * np.inf)
    return out


def fixed_point_study(n):
    z, y = fuzz_instance(7)
    zs = one_ulp_changes(z, n, seed=1)
    ys = np.repeat(y[None], n + 1, axis=0)
    _, r_port, _ = ssn.ssn_all_prefixes(torch.from_numpy(zs),
                                        torch.from_numpy(ys), iters=2000,
                                        tol=1e-5)
    solve = jax.jit(lambda a, b: jax_ssn.ssn_all_prefixes(
        a, b, iters=2000, tol=1e-5)[1])
    r_jax = np.stack([np.asarray(solve(jnp.asarray(a), jnp.asarray(y)))
                      for a in zs])
    for name, r in (("port", r_port.numpy()), ("JAX", r_jax)):
        g = r[:, D - 1]
        print(f"fuzz seed 7 (T = {len(y)}), prefix of length {D}, {name}: "
              f"certified gap {g[0]:.3e} on z; over {n} one-ulp changes of "
              f"z, {int((g[1:] > 1e-5).sum())} above 1e-5, gap from "
              f"{g[1:].min():.3e} to {g[1:].max():.3e}; the longer "
              f"prefixes' largest gap {r[:, D:].max():.3e}", flush=True)


def card_test_study(n=12):
    rng = np.random.default_rng(0)
    B, T = 2, 60
    z = 2.0 * rng.normal(size=(B, T, D))
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(B, D)))
                + 0.3 * rng.normal(size=(B, T)))
    m = np.tril(np.ones((T, T)))

    def objective(X):
        return 0.5 * (np.abs(np.einsum("btd,bpd->bpt", z, X)
                             - y[:, None]) * m).sum(-1)

    zs = one_ulp_changes(z, n, seed=2)
    f = []
    for zk in zs:
        X, _, _ = ssn.ssn_all_prefixes(torch.from_numpy(zk),
                                       torch.from_numpy(y), iters=10,
                                       tol=0.0)
        f.append(objective(X.numpy()))
    f = np.stack(f)
    rel = (np.abs(f[1:] - f[0]) / (1 + np.abs(f[0]))).max(axis=(0, 1))
    print(f"the card test's instance (B = {B}, T = {T}), 10 fixed steps on "
          f"the CPU, {n} one-ulp changes of z: the largest change of a "
          f"prefix objective over 1 + f, by prefix length 1..{D - 1}: "
          + ", ".join(f"{v:.3e}" for v in rel[:D - 1])
          + f"; at {D} rows and more {rel[D - 1:].max():.3e}", flush=True)


def pipeline_study(n=12):
    from online_convex_optimization_tpu_torch.data.sequences import CASES
    from online_convex_optimization_tpu_torch.experiments.evaluate import (
        evaluate_stream_exact)
    from online_convex_optimization_tpu_torch.models import polish
    solve, keep = ssn.ssn_all_prefixes, polish.polish_prefix_actions
    change, acts = [None], []

    def changed_solve(z, y, **kw):
        if change[0] is not None:
            t, j, s = change[0]
            z = z.clone()
            z[..., t, j] = torch.nextafter(z[..., t, j], torch.full_like(
                z[..., t, j], s * np.inf))
        return solve(z, y, **kw)

    def kept(z, y, a, *args, **kw):
        out = keep(z, y, a, *args, **kw)
        acts.append(out)
        return out

    ssn.ssn_all_prefixes, polish.polish_prefix_actions = changed_solve, kept
    try:
        stats = []
        for c in [None] + ulp_entries(n, seed=3):
            change[0] = c
            acts.clear()
            got = evaluate_stream_exact(
                CASES["Random i.i.d. (separable)"], T_grid=[40, 60], runs=1,
                replicates=2, solver="ssn", progress=False, device="cpu")
            stats.append((np.asarray(got["FTL (exact)"][0]), list(acts)))
    finally:
        ssn.ssn_all_prefixes, polish.polish_prefix_actions = solve, keep
    base, base_acts = stats[0]
    moved = max(np.abs(v - base).max() for v, _ in stats[1:])
    moved_long = max(np.abs(a[D:] - b[D:]).max()
                     for _, al in stats[1:] for a, b in zip(al, base_acts))
    print(f"the card test's pipeline cut on the CPU: exact-FTL regret "
          f"{base.tolist()} (T = 40, 60); over {n} one-ulp changes of the "
          f"SSN's input it moves by up to {moved:.3e}, the polished actions "
          f"of the prefixes of at least {D} rows by up to {moved_long:.3e}",
          flush=True)


def steps_study(tol=2e-4, cap=1000):
    rng = np.random.default_rng(0)
    B, T = 2, 60
    z = 2.0 * rng.normal(size=(B, T, D))
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(B, D)))
                + 0.3 * rng.normal(size=(B, T)))
    step = jax.jit(lambda a, b, st: jax_ssn.ssn_all_prefixes(
        a, b, iters=1, tol=tol, state0=st))
    for b in range(B):
        counts = {}
        ssn.ssn_all_prefixes(torch.from_numpy(z[b]), torch.from_numpy(y[b]),
                             iters=cap, tol=tol, counts=counts)
        zj, yj = jnp.asarray(z[b]), jnp.asarray(y[b])
        st = (jnp.zeros((T, D)), jnp.full((T, 1), max(np.abs(y[b]).max(),
                                                       1.0)))
        for k in range(1, cap + 1):
            _, res, st = step(zj, yj, st)
            if float(jnp.max(res)) <= tol:
                break
        print(f"the card test's instance, member {b}: Newton steps to tol "
              f"{tol:g}: port {counts['steps']}, JAX {k}"
              f"{'' if float(jnp.max(res)) <= tol else ' (not reached)'}",
              flush=True)


def main() -> int:
    n = 24
    if "--changes" in sys.argv:
        n = int(sys.argv[sys.argv.index("--changes") + 1])
    steps_study()
    if "--steps" in sys.argv:
        return 0
    card_test_study()
    pipeline_study()
    fixed_point_study(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
