"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package per TPU
kernel of ``repro.kernels`` that the port has replaced.

Each package holds ``ops.py`` (the wrapper: checks its inputs, runs the
plain PyTorch version for a CPU tensor and launches the CUDA kernel for a
CUDA tensor) and ``ref.py`` (the plain versions).  The CUDA sources are in
``csrc/``; ``_build`` compiles and loads them on first use and counts the
launches.
"""
