"""zonos-tpu on PyTorch and CUDA: the port of the JAX package
``zonos_vibes_tpu`` to one NVIDIA H100.

It imports nothing of the JAX package. The hand-written Hopper kernels live
in ``csrc/`` and are built at first use (``ops/cuda/build.py``); the user
entry point is :class:`zonos_vibes_tpu_torch.pipeline.ZonosPipeline`.
"""
