"""repro_torch: the PyTorch + CUDA port of ``repro`` (VStore).

The package mirrors ``src/repro/`` path for path; each module names the
reference module it ports.  It imports neither ``jax`` nor ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; hand-written kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``repro_torch.kernels.build``).
"""
