"""Hand-written Hopper kernels of the port, one folder per TPU kernel of the
reference (``src/repro/kernels/<name>/``).  Each folder keeps the
reference's three files: ``<name>.py`` (the CUDA wrapper), ``ops.py``
(dispatch on the tensor's device) and ``ref.py`` (the plain PyTorch
version).  ``build`` compiles the sources in ``repro_torch/csrc/``."""
