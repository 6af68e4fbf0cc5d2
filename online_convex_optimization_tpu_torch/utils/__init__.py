"""Stats, logging, checkpointing and the CUDA build (counterpart of
``online_convex_optimization_tpu/utils``)."""
