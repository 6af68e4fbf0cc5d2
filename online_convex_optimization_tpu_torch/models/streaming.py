"""Streaming (chunked-time) simulation for horizons beyond device memory.

Counterpart of ``online_convex_optimization_tpu/models/streaming.py``
(``StreamingGame``, ``StreamingKernelGame``).  The carry (theta, w, cum,
cnt) is O(B d), so only the active chunk of (z, y) needs to be resident:
T = 10^6 and more per sequence at constant device memory, with results
equal to the one-shot simulator.  Both classes advance through kernel K4
(``ops/game.py::play_stream``) on a CUDA device, the default, and through
its plain version on the CPU (``device="cpu"``); the carry checkpoints
and resumes through ``carry_state`` / ``resume``
(``utils/checkpointing.py``).

- ``StreamingGame.result(replay_feed)`` keeps the JAX semantics: the final
  FTL comparator is scored by replaying the fed chunks, with an elementwise
  product and an index-order sum (IEEE f32/f64, no TF32), as the JAX
  package's einsum at HIGHEST precision does.
- ``StreamingKernelGame.result()`` scores it from the carried identity
  statistics, with no replay; that is exact only on contract data
  (``||z_t|| <= 1``, labels +-1, zero padding rows), which ``validate=True``
  checks for every chunk.

The round counter ``t`` is the number of rounds played (the JAX
``StreamingGame`` keeps the next 1-based index instead).  Chunks are fed
time-major: ``feed`` takes the JAX layout ``(CT, B, d)`` / ``(CT, B)``;
``feed_packed`` and ``feed_many_packed`` take the kernels' ``(CT, d, B)``
(``data/device.py::random_time_major_batch``) with no repack.

``dtype`` and ``y_dtype`` (default ``dtype``) are the chunks' storage, a
pair of ``ops/game.py::STORAGE``: bf16 z with bf16 or int8 labels, as the
JAX ``StreamingKernelGame(dtype=jnp.bfloat16)`` stores them, is played by
K4 reading the narrow chunk; the carry is in the compute dtype (float32).
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple

import numpy as np
import torch

from online_convex_optimization_tpu_torch.models.base import RunResult
from online_convex_optimization_tpu_torch.ops.actions import ftl_action, sum_last
from online_convex_optimization_tpu_torch.ops.game import (
    ALG_FTRL,
    StreamCarry,
    advance_stream,
    compute_dtype,
    per_sequence,
    play_stream_many,
    storage_suffix,
    stream_result,
    validate_stream_chunk,
    zero_stream_carry,
)
from online_convex_optimization_tpu_torch.ops.hinge import normalized_hinge
from online_convex_optimization_tpu_torch.utils.devices import resolve_device


class _Stream:
    """Carry, round counter and per-sequence settings shared by both
    games."""

    def __init__(self, B: int, d: int, *, alg_flag=ALG_FTRL, eta0=1.0,
                 dtype=torch.float32, y_dtype=None, device="cuda"):
        self.B, self.d = B, d
        self.dtype = dtype
        self.y_dtype = dtype if y_dtype is None else y_dtype
        storage_suffix(self.dtype, self.y_dtype)
        self.compute = compute_dtype(dtype)
        self.device = resolve_device(device)
        self.flags = per_sequence(alg_flag, B, torch.int32, self.device)
        self.eta0 = per_sequence(eta0, B, self.compute, self.device)
        self.carry = zero_stream_carry(B, d, self.compute, self.device)
        self.t = 0

    def _chunk(self, z_chunk, y_chunk):
        """A ``(CT, B, d)`` / ``(CT, B)`` chunk -> time-major tensors on the
        game's device in its storage dtypes."""
        z = torch.as_tensor(z_chunk).to(self.device, self.dtype)
        y = torch.as_tensor(y_chunk).to(self.device, self.y_dtype)
        if z.ndim != 3:
            raise ValueError(f"expected z (CT, B, d), got {tuple(z.shape)}")
        return z.permute(0, 2, 1).contiguous(), y.contiguous()

    def _advance(self, z_tm, y_tm) -> None:
        self.carry = advance_stream(z_tm, y_tm, self.flags, self.eta0,
                                    self.t, self.carry)
        self.t += int(z_tm.shape[0])

    def feed(self, z_chunk, y_chunk) -> None:
        """Play one ``(CT, B, d)`` / ``(CT, B)`` time-major chunk."""
        self._advance(*self._chunk(z_chunk, y_chunk))

    def comparator_action(self) -> torch.Tensor:
        """Final FTL action per sequence, ``(B, d)``."""
        return ftl_action(self.carry.theta.t())

    # ---- checkpoint/resume (tiny O(B d) carry) ----
    def carry_state(self) -> dict:
        """The carry and the round counter as NumPy arrays, for
        ``utils/checkpointing.save_pytree``."""
        state = {k: v.detach().cpu().numpy()
                 for k, v in self.carry._asdict().items()}
        state["t"] = np.asarray(self.t, dtype=np.int64)
        return state

    def resume(self, saved: dict) -> None:
        """Restore a ``carry_state()`` (bits unchanged)."""
        carry = StreamCarry(*(torch.tensor(np.asarray(saved[k])).to(
            self.device, self.compute) for k in StreamCarry._fields))
        want = zero_stream_carry(self.B, self.d, self.compute, self.device)
        for name, got, ref in zip(StreamCarry._fields, carry, want):
            if got.shape != ref.shape:
                raise ValueError(f"saved {name} has shape {tuple(got.shape)}"
                                 f", this game needs {tuple(ref.shape)}")
        self.carry = carry
        self.t = int(saved["t"])


class StreamingGame(_Stream):
    """Feed arbitrary-length sequences through the game chunk by chunk.

    Usage:
        game = StreamingGame(B, d, alg_flag=0, eta0=2**0.5, device="cuda")
        for z_chunk, y_chunk in feed:     # (CT, B, d), (CT, B) time-major
            game.feed(z_chunk, y_chunk)
        result = game.result(comparator_feed)   # replay pass for comp loss
    """

    def result(self, replay_feed: Iterable[Tuple[Any, Any]]) -> RunResult:
        """Finish: replay the sequence against the final FTL action.

        ``replay_feed`` re-yields the same ``(z_chunk, y_chunk)`` stream
        (the reference scores its comparator with one more pass over the
        data, fast_algorithms.py:113-115).  The rows are scored as they were
        stored (rounded to the game's storage dtypes).
        """
        x_c = self.comparator_action()
        comp = torch.zeros_like(self.carry.cum)
        for z_chunk, y_chunk in replay_feed:
            z = torch.as_tensor(z_chunk).to(self.device, self.dtype).to(
                self.compute)
            y = torch.as_tensor(y_chunk).to(self.device, self.y_dtype).to(
                self.compute)
            q = sum_last(z * x_c[None])                        # (CT, B)
            comp = comp + torch.sum(normalized_hinge(q, y), dim=0)
        cum = self.carry.cum
        return RunResult(cum_loss=cum, regret=cum - comp, comp_loss=comp,
                         x_last=x_c)


class StreamingKernelGame(_Stream):
    """Streaming at kernel speed with a replay-free comparator: the carried
    identity statistics score the final FTL action in O(d).

    Requires the data contract (``||z_t|| <= 1``, labels +-1, zero padding
    rows); ``validate=True`` checks every chunk on its device and raises
    for one outside it (a sync per chunk).  Without it the contract is the
    caller's, as in the JAX package.

    Usage:
        game = StreamingKernelGame(B, d, alg_flag=0, eta0=2**0.5,
                                   device="cuda")
        for z_chunk, y_chunk in feed:   # (CT, B, d), (CT, B) time-major
            game.feed(z_chunk, y_chunk)
        res = game.result()             # (B,) fields, no second pass
    """

    def __init__(self, B: int, d: int, *, alg_flag=ALG_FTRL, eta0=1.0,
                 dtype=torch.float32, y_dtype=None, device="cuda",
                 validate: bool = False):
        super().__init__(B, d, alg_flag=alg_flag, eta0=eta0, dtype=dtype,
                         y_dtype=y_dtype, device=device)
        self.validate = validate

    def _advance(self, z_tm, y_tm) -> None:
        if self.validate:
            validate_stream_chunk(z_tm, y_tm)
        super()._advance(z_tm, y_tm)

    def feed_packed(self, z_tm: torch.Tensor, y_tm: torch.Tensor) -> None:
        """Play a chunk already in the kernels' layout, ``(CT, d, B)`` /
        ``(CT, B)`` on the game's device (e.g. generated there)."""
        self._advance(z_tm, y_tm)

    def feed_many_packed(self, z_stack: torch.Tensor,
                         y_stack: torch.Tensor) -> None:
        """Play N stacked chunks ``(N, CT, d, B)`` / ``(N, CT, B)`` through
        ``play_stream_many``: one K4 launch per chunk, no host sync between
        them (unless ``validate``, which checks every chunk first)."""
        if z_stack.ndim != 4 or y_stack.ndim != 3:
            raise ValueError(f"expected z (N, CT, d, B) and y (N, CT, B), "
                             f"got {tuple(z_stack.shape)} and "
                             f"{tuple(y_stack.shape)}")
        if self.validate:
            for z_tm, y_tm in zip(z_stack, y_stack):
                validate_stream_chunk(z_tm, y_tm)
        self.carry = play_stream_many(z_stack, y_stack, self.eta0, self.t,
                                      self.carry, alg_flag=self.flags)
        self.t += int(z_stack.shape[0] * z_stack.shape[1])

    def result(self) -> RunResult:
        regret, cum, comp = stream_result(self.carry)
        return RunResult(cum_loss=cum, regret=regret, comp_loss=comp,
                         x_last=self.comparator_action())
