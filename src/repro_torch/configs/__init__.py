"""Experiment and model configurations."""

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import ARCH_NAMES, ArchSpec, get_arch

__all__ = ["ARCH_NAMES", "ArchSpec", "FLRunConfig", "ModelConfig", "get_arch"]
