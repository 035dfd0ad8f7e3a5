"""K1 and K3 wrappers: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.  ``repro_torch.kernels.gram.ops.kernel_from_profiles``
calls K1 (through :func:`pairwise_dists_range`) as launch 1 of the profiles
-> DPP-kernel pipeline; ``repro_torch.core.similarity.pairwise_sq_dists(
use_kernel=True)`` calls K3, the stage-wise route.  Each call is one
launch (``csrc/pairwise_l2.cu``), whose shape :func:`plan` gives."""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_l2.ref import pairwise_dists_stats_ref, pairwise_sq_dists_ref

__all__ = ["Plan", "plan", "cuda_plan", "pairwise_dists_range", "pairwise_dists_stats", "pairwise_sq_dists"]

# make_plan in csrc/pairwise_l2.cu, mirrored by plan() below
_SMS, _MIN_RANGE, _MAX_RANKS = 132, 32, 8


class Plan(NamedTuple):
    """The launch of a (C, Q) call: ``tiles`` upper-triangle output tiles of
    edge ``tile``, each a cluster of ``ranks`` blocks, rank r summing the
    terms ``span(r, Q)``; in a block, ``groups`` groups of threads, group g
    summing every ``groups``-th term of its rank's span from the g-th."""

    tile: int
    ranks: int
    tiles: int

    def span(self, r: int, q: int):
        """Rank r's terms of Q: ``range(r Q / S, (r + 1) Q / S)``."""
        return range(r * q // self.ranks, (r + 1) * q // self.ranks)

    @property
    def blocks(self) -> int:
        return self.tiles * self.ranks

    @property
    def groups(self) -> int:
        return 4 if self.tile == 16 else 1


def plan(c: int, q: int) -> Plan:
    """The plan ``pairwise_l2_plan`` gives for (c, q), computed in Python:
    tile 16 at C <= 128, 32 at C <= 1,024, else 64; ranks the smallest
    power of two (at most 8) whose blocks fill the 132 SMs, while each rank
    keeps at least 32 terms."""
    tile = 16 if c <= 128 else (32 if c <= 1024 else 64)
    t = -(-c // tile)
    tiles = t * (t + 1) // 2
    ranks = 1
    while ranks < _MAX_RANKS and tiles * ranks < _SMS and q // (2 * ranks) >= _MIN_RANGE:
        ranks *= 2
    return Plan(tile, ranks, tiles)


def cuda_plan(c: int, q: int) -> Plan:
    """The plan the CUDA library itself takes for (c, q) (builds it)."""
    out = (ctypes.c_int * 3)()
    _build.library("pairwise_l2").pairwise_l2_plan(c, q, out)
    return Plan(*out)


_DTYPES = (torch.float32, torch.bfloat16)
# K1's launch by (C, Q, device index, stream): the binding's two entry
# points, the addresses of the library's launch and error-string functions,
# the length of the output buffer (S0, then lo, hi, rng, the tiles' minima
# and their maxima), and the ticket counter's address and the counter (0
# between launches: launches on one stream never overlap)
_K1: Dict[Tuple[int, int, int, int], tuple] = {}


def _check_profiles(f: torch.Tensor) -> None:
    if f.is_cuda and f.dim() == 2 and f.dtype in _DTYPES and f.numel() > 0 and f.is_contiguous():
        return  # the wrappers' usual case, in a fraction of the checks' host time
    if f.ndim != 2:
        raise ValueError(f"profiles must be (C, Q), got {tuple(f.shape)}")
    if f.dtype not in _DTYPES:
        raise TypeError(f"profiles must be float32 or bfloat16, got {f.dtype}")
    if f.shape[0] < 1 or f.shape[1] < 1:
        raise ValueError(f"profiles must be non-empty, got {tuple(f.shape)}")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {f.device}")
    if f.device.type == "cuda" and not f.is_contiguous():
        raise ValueError("profiles must be contiguous")


def pairwise_sq_dists(f: torch.Tensor) -> torch.Tensor:
    """F (C, Q) fp32 or bf16 -> D2 (C, C) fp32 on F's device:
    ``D2[i, j] = ‖f_i − f_j‖²₂``, clamped at 0, with the diagonal exactly 0
    (K3; bf16 profiles are upcast in the kernel).  On the card D2 is exactly
    symmetric and the same bits on every call."""
    _check_profiles(f)
    if not f.is_cuda:
        return pairwise_sq_dists_ref(f)
    c, q = f.shape
    lib = _build.library("pairwise_l2")
    d2 = torch.empty((c, c), dtype=torch.float32, device=f.device)
    with _build.on_device(f.device):
        err = lib.pairwise_l2_sq_dists(
            f.data_ptr(), int(f.dtype == torch.bfloat16), c, q, d2.data_ptr(),
            _build.stream(f.device),
        )
    _build.check("pairwise_l2", err, "pairwise_sq_dists")
    _build.LAUNCHES["pairwise_sq_dists"] += 1
    return d2


def _k1(f: torch.Tensor, with_range: bool) -> tuple:
    """Launches K1 on CUDA profiles through its host binding
    (``csrc/pairwise_l2_bind.cpp``), which takes F's device, allocates the
    output buffer and returns (S0, lo, hi), and rng with ``with_range``, as
    views of it.  The per-call work is kept to what the launch needs: at
    the FL paths' shapes the host's time, not the kernel's, sets the call's."""
    dev = f.device
    strm = _build.stream(dev)
    key = (*f.shape, dev.index, strm)
    hit = _K1.get(key)
    if hit is None:
        bind, lib = _build.binding("pairwise_l2_bind"), _build.library("pairwise_l2")
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        hit = _K1[key] = (
            bind.dists_stats, bind.dists_range,
            ctypes.cast(lib.pairwise_l2_dists_stats, ctypes.c_void_p).value,
            ctypes.cast(lib.pairwise_l2_error_string, ctypes.c_void_p).value,
            key[0] * key[0] + 3 + 2 * cuda_plan(key[0], key[1]).tiles, ticket.data_ptr(), ticket,
        )
    out = (hit[1] if with_range else hit[0])(f, *hit[2:6], strm)
    _build.LAUNCHES["pairwise_dists_stats"] += 1
    return out


def pairwise_dists_range(
    f: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """F (C, Q) fp32 or bf16 -> (S0 (C, C) fp32, lo, hi, rng): K1 as
    :func:`pairwise_dists_stats` gives it, plus ``rng = max(hi − lo,
    1e-30)``, the range eq. (14) divides by, a 0-d fp32 tensor on F's
    device (on the card, written by the same launch)."""
    _check_profiles(f)
    if not f.is_cuda:
        s0, lo, hi = pairwise_dists_stats_ref(f)
        return s0, lo, hi, torch.clamp_min(hi - lo, 1e-30)
    return _k1(f, True)


def pairwise_dists_stats(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F (C, Q) fp32 or bf16 -> (S0 (C, C) fp32, lo, hi).

    ``S0[i, j] = ‖f_i − f_j‖₂`` with the diagonal exactly 0; ``lo`` and
    ``hi`` are 0-d fp32 tensors on F's device holding the min and max of S0.
    Nothing is copied to the host.  On the card this is one launch, S0 is
    exactly symmetric and the same bits on every call, and it is the fp32
    square root of :func:`pairwise_sq_dists`'s D2 bit for bit.
    """
    _check_profiles(f)
    if not f.is_cuda:
        return pairwise_dists_stats_ref(f)
    return _k1(f, False)
