"""Runnable examples of the port (counterpart of the repository's
``examples/``): ``python -m online_convex_optimization_tpu_torch.examples.<name>
--device cuda|cpu``."""
