"""Long-horizon streaming with checkpoint/resume.

Feeds long sequences through the game in chunks (kernel K4 on a CUDA
device, its plain version on the CPU); the O(B d) carry, which holds the
identity statistics so the comparator needs no replay pass, is
checkpointed mid-run and resumed.  The same steps as the JAX package's
``examples/streaming_long_horizon.py``.

    python -m online_convex_optimization_tpu_torch.examples.streaming_long_horizon --device cpu
    python -m online_convex_optimization_tpu_torch.examples.streaming_long_horizon --device cuda
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from online_convex_optimization_tpu_torch.data.device import (
    random_time_major_batch,
)
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.utils.checkpointing import (
    load_pytree,
    save_pytree,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device")
    B, d, CT, N = args.batch, 5, args.chunk, args.chunks
    game = StreamingKernelGame(B, d, eta0=2 ** 0.5, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "carry.npz")
        for i in range(N):
            game.feed_packed(*random_time_major_batch(gen, CT, B, d))
            if i == N // 2:                  # mid-run checkpoint round-trip
                save_pytree(path, game.carry_state())
                game.resume(load_pytree(path))
    res = game.result()                      # no replay pass
    print(f"T={game.t}: mean regret {float(res.regret.mean()):.3f} "
          f"(cum {float(res.cum_loss.mean()):.1f}, "
          f"comp {float(res.comp_loss.mean()):.1f})")
    return res


if __name__ == "__main__":
    main()
