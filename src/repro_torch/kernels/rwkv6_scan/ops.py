"""K7 wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  ``repro_torch.models.rwkv6.apply_rwkv_tmix(use_kernel=True)``
calls it once per layer on every prefill and decode step; the transformer
sets ``use_kernel`` from its ``use_flash`` switch."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref

__all__ = ["design", "wkv6", "wkv6_flops"]

HEAD_DIMS = (8, 16, 32, 64)  # the kernel's templates
CHUNK = 16  # tokens per chunk of the chunked design (kL in wkv6.cu)


def design(b: int, t: int, h: int, hd: int) -> int:
    """The CUDA design a call of this shape takes (``wkv6_plan``): 0 for the
    recurrent kernel, else the number of value slices of the chunked one.
    Needs a card: the slices follow its SM count."""
    return int(_build.library("wkv6").wkv6_plan(b, t, h, hd))


def wkv6_flops(b: int, t: int, h: int, hd: int) -> float:
    """FLOPs of the recurrence, the JAX package's count
    (``analysis.roofline._wkv_flops_correction``): 8·hd² per head and
    token, the state update and the readout."""
    return 8.0 * hd * hd * h * b * t


def wkv6(
    r: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, hd) decay in (0, 1)
    u: torch.Tensor,  # (H, hd) bonus
    s0: torch.Tensor,  # (B, H, hd, hd) state
):
    """-> (y (B, T, H, hd) in r's dtype, final state (B, H, hd, hd) fp32).

    Per (b, h): ``y_t = r_tᵀ (S + diag(u ⊙ k_t) v_tᵀ)``, then
    ``S ← diag(w_t) S + k_t v_tᵀ``, in fp32 from ``S = s0``.  On the card
    r/k/v are all fp32 or all bf16, and w, u and s0 fp32.

    Two designs on the card, chosen by shape alone (``csrc/wkv6.cu``; a
    call counts one launch in ``LAUNCHES`` whichever runs): fp32 or bf16
    alike, T < 16 (the decode step) and
    hd = 8 take the recurrent kernel, one block per (b, h); T >= 16 with hd
    in {16, 32, 64} (rwkv6-7b's bf16 hd-64 prefill) takes the chunked one,
    chunks of 16 tokens with the products on the tensor cores, one block
    per (b, h, slice of the value columns) running the chunks in order.
    With more than one slice a first kernel forms each chunk's intra-chunk
    matrix A once, in a workspace allocated here.

    Fake tensors (the dry run) launch nothing: the call returns outputs of
    the kernel's shapes and dtypes and records :func:`wkv6_flops`; the
    chunked design's workspace (its size follows the card) is not
    allocated.

    Forward only, like the TPU kernel it replaces (no VJP there, no
    backward here): it raises when grad is enabled and an input requires
    grad."""
    if r.ndim != 4:
        raise ValueError("r/k/v/w must be (B, T, H, head_dim)")
    b, t, h, hd = r.shape
    if any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(
            f"r/k/v/w must share one shape, got {[tuple(x.shape) for x in (r, k, v, w)]}"
        )
    if s0.shape != (b, h, hd, hd):
        raise ValueError(f"bad state shape {tuple(s0.shape)}, want {(b, h, hd, hd)}")
    if u.shape != (h, hd):
        raise ValueError(f"bad bonus shape {tuple(u.shape)}, want {(h, hd)}")
    if min(b, t, h, hd) < 1:
        raise ValueError("r/k/v/w must be non-empty")
    inputs = (r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        raise RuntimeError(
            "wkv6 (K7) is forward-only: it has no backward, as the TPU kernel has no "
            "VJP; run it under torch.no_grad() or take the plain scan"
        )
    devices = {x.device for x in inputs}
    if len(devices) != 1:
        raise ValueError(f"r, k, v, w, u and s0 must share one device, got {devices}")
    if _build.is_fake(r):
        y, s_out = torch.empty_like(r), torch.empty_like(s0)
        _build.fake_call("wkv6", wkv6_flops(b, t, h, hd), inputs + (y, s_out))
        return y, s_out
    if r.device.type == "cpu":
        y, s_out = wkv6_scan_ref(r, k, v, w, u, s0)
        return y.to(r.dtype), s_out
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    if r.dtype not in (torch.float32, torch.bfloat16) or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r/k/v must all be float32 or all bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in (w, u, s0)):
        raise ValueError(f"w, u and s0 must be float32, got {w.dtype}, {u.dtype}, {s0.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd} must be one of {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError("r, k, v, w, u and s0 must be contiguous")
    lib = _build.library("wkv6")
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    # A of every chunk, for the chunked design with more than one slice
    nbytes = lib.wkv6_workspace(b, t, h, hd)
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=r.device) if nbytes else None
    with _build.on_device(r.device):
        err = lib.wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), None if ws is None else ws.data_ptr(),
            int(r.dtype == torch.bfloat16), b, t, h, hd,
            _build.stream(r.device),
        )
    _build.check("wkv6", err, "wkv6")
    _build.LAUNCHES["wkv6"] += 1
    return y, s_out
