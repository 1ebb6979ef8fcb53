"""PyTorch/CUDA port of :mod:`repro`.

The port serves the same decoder on an NVIDIA H100: plain tensor code is
PyTorch, and each Pallas TPU kernel of the reference becomes a CUDA
kernel written by hand for Hopper (``kernels/csrc``).  It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and
never :mod:`repro`; the modules it needs from the framework-free half of
the reference are copied under ``core/`` and ``serving/``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper uses its plain PyTorch version.
"""
