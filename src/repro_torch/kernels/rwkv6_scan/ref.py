"""Plain PyTorch version of K7: the model's sequential scan."""

from repro_torch.models.rwkv6 import wkv6_scan_ref

__all__ = ["wkv6_scan_ref"]
