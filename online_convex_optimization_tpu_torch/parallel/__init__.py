"""Sharded sweeps on ``torch.distributed`` (counterpart of
``online_convex_optimization_tpu/parallel``): rank meshes, the sharded
reductions and the pod-scale g sweep, the multi-process worker and the
scaling harness."""
