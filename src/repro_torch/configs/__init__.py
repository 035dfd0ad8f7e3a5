"""Experiment and model configurations."""

import dataclasses
from typing import Optional

from repro_torch.configs.base import FLRunConfig, ModelConfig
from repro_torch.configs.registry import ARCH_NAMES, ArchSpec, get_arch

__all__ = ["ARCH_NAMES", "ArchSpec", "FLRunConfig", "ModelConfig", "get_arch", "model_config"]


def model_config(arch: str, full_width: bool = False, layers: Optional[int] = None) -> ModelConfig:
    """The config the launchers run: the arch's ``reduced`` variant in fp32
    without remat, as the JAX launchers run it, or with ``full_width`` the
    published config, cut to its first ``layers`` layers when given (a
    multiple of its block pattern's length, at most its depth)."""
    cfg = get_arch(arch).model
    if layers is not None:
        n = len(cfg.block_pattern)
        if not full_width:
            raise ValueError("--layers cuts the published config: it needs --full-width")
        if layers < n or layers % n or layers > cfg.num_layers:
            raise ValueError(
                f"--layers {layers}: {arch} takes a multiple of its block pattern's "
                f"{n} layers {cfg.block_pattern}, at most its {cfg.num_layers}"
            )
        return dataclasses.replace(cfg, num_layers=layers)
    if full_width:
        return cfg
    return cfg.reduced(param_dtype="float32", dtype="float32", remat=False)
