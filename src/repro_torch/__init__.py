"""PyTorch + CUDA port of the split-learning system in ``repro``.

The JAX package ``repro`` is the reference; this package runs the same
``ExperimentSpec`` main path (``repro_torch.api.compile_experiment``) and
the transformer trainer (``repro_torch.launch.train``) in PyTorch, with the
hand-written Hopper kernels under ``csrc/``. It imports
neither ``jax`` nor ``repro``. Submodules are imported on demand; this file
imports nothing.
"""
