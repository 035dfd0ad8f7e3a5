"""PyTorch/CUDA port of the FL-DP³S system (``repro``), for NVIDIA Hopper.

Mirrors the JAX package's layout (``core/``, ``data/``, ``kernels/``,
``models/``, ``optim/``, ``fl/``, ``configs/``) with the same module and
function names.  It imports neither JAX nor anything of ``repro``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
