"""The paper's CNN: two conv layers + two fully-connected layers (§4).

Layout follows the JAX package at the public functions: images go in as
NHWC ``(N, 28, 28, 1)``, and FC-1 reads the conv features flattened in
(h, w, c) order.  Inside, the convolutions run NCHW/OIHW as PyTorch does.

Parameters are a plain ``dict`` of tensors in the state-dict naming of
:class:`CNN` (``"conv1.weight"``, ...), so that FedAvg can copy, update and
average them as a pytree, and ``CNN().load_state_dict(params)`` gives the
module.  ``apply_with_features`` exposes the FC-1 *pre-activation* outputs —
the ``h_q`` of Theorem 1 — for data profiling (eq. 11).  Four
parameter-initialisation schemes serve the Fig. 4-6 robustness experiments.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "CNN",
    "INIT_SCHEMES",
    "accuracy",
    "apply_cnn",
    "apply_with_features",
    "cnn_loss",
    "init_cnn",
    "params_from_jax",
    "params_to_jax",
]

Params = Dict[str, torch.Tensor]


def _fan_in_out(shape) -> Tuple[int, int]:
    if len(shape) == 4:  # OIHW conv kernel
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    return shape[1], shape[0]  # (out, in) linear weight


def _kaiming_uniform(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in, _ = _fan_in_out(w.shape)
    bound = math.sqrt(6.0 / fan_in)
    w.uniform_(-bound, bound, generator=g)


def _kaiming_normal(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in, _ = _fan_in_out(w.shape)
    w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)


def _xavier_uniform(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in, fan_out = _fan_in_out(w.shape)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-bound, bound, generator=g)


def _xavier_normal(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in, fan_out = _fan_in_out(w.shape)
    w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=g)


INIT_SCHEMES = {
    "kaiming_uniform": _kaiming_uniform,
    "kaiming_normal": _kaiming_normal,
    "xavier_uniform": _xavier_uniform,
    "xavier_normal": _xavier_normal,
}


class CNN(nn.Module):
    """2-conv/2-FC CNN: 5×5 "SAME" convs, 2×2 max-pools, FC-1 width = Q."""

    def __init__(
        self,
        num_classes: int = 10,
        in_hw: Tuple[int, int] = (28, 28),
        channels: Tuple[int, int] = (16, 32),
        fc1_dim: int = 128,
    ):
        super().__init__()
        h, w = in_hw
        flat = (h // 4) * (w // 4) * channels[1]  # two 2x2 maxpools
        self.conv1 = nn.Conv2d(1, channels[0], 5, padding=2)
        self.conv2 = nn.Conv2d(channels[0], channels[1], 5, padding=2)
        self.fc1 = nn.Linear(flat, fc1_dim)
        self.fc2 = nn.Linear(fc1_dim, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images -> (logits, FC-1 pre-activations)."""
        return apply_with_features(dict(self.named_parameters()), x)


def init_cnn(
    generator: torch.Generator,
    num_classes: int = 10,
    in_hw: Tuple[int, int] = (28, 28),
    channels: Tuple[int, int] = (16, 32),
    fc1_dim: int = 128,
    scheme: str = "kaiming_uniform",
) -> Params:
    """Initialise the CNN's parameters with ``scheme`` (zero biases), drawing
    from ``generator``; they land on the generator's device."""
    init = INIT_SCHEMES[scheme]
    with torch.device("meta"):  # shapes and names only; no default init drawn
        shapes = CNN(num_classes, in_hw, channels, fc1_dim).state_dict()
    params = {}
    for name, meta in shapes.items():
        t = torch.zeros(meta.shape, device=generator.device)
        if name.endswith(".weight"):
            init(t, generator)
        params[name] = t
    return params


def params_from_jax(np_params: Mapping, device=None) -> Params:
    """The JAX CNN's param dict (numpy leaves) -> this module's parameters.

    Conv kernels are HWIO in JAX and become OIHW; linear weights are
    (in, out) in JAX and become (out, in).  FC-1 needs nothing more: the
    forward pass flattens NHWC features in the JAX (h, w, c) order.
    """
    out = {}
    for name in ("conv1", "conv2", "fc1", "fc2"):
        w = np.asarray(np_params[name]["w"], np.float32)
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
        out[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(w), device=device)
        out[f"{name}.bias"] = torch.tensor(
            np.asarray(np_params[name]["b"], np.float32), device=device
        )
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, Params]:
    """The inverse of :func:`params_from_jax` on tensors: this module's
    parameters (or their gradients) -> the JAX CNN's nested dict, with conv
    kernels HWIO and linear weights (in, out), as views.  Flattened with
    its keys sorted, it gives the leaves in ``jax.tree_util``'s order, which
    the Fig.-3 gradient profiles (``core.profiles``) concatenate."""
    out = {}
    for name in ("conv1", "conv2", "fc1", "fc2"):
        w = params[f"{name}.weight"]
        out[name] = {
            "w": w.permute(2, 3, 1, 0) if w.ndim == 4 else w.T,
            "b": params[f"{name}.bias"],
        }
    return out


def apply_with_features(params: Mapping[str, torch.Tensor], x: torch.Tensor):
    """Forward pass on NHWC images returning (logits, FC-1 pre-activations).

    The FC-1 pre-activation is the Theorem-1 variable whose per-neuron mean
    over the local dataset forms the client's data profile f_c (eq. 11).
    """
    h = x.permute(0, 3, 1, 2)
    h = F.conv2d(h, params["conv1.weight"], params["conv1.bias"], padding=2)
    h = F.max_pool2d(F.relu(h), 2)
    h = F.conv2d(h, params["conv2.weight"], params["conv2.bias"], padding=2)
    h = F.max_pool2d(F.relu(h), 2)
    h = h.permute(0, 2, 3, 1).flatten(1)  # (h, w, c) order; also for 0 rows
    fc1_pre = F.linear(h, params["fc1.weight"], params["fc1.bias"])
    logits = F.linear(F.relu(fc1_pre), params["fc2.weight"], params["fc2.bias"])
    return logits, fc1_pre


def apply_cnn(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return apply_with_features(params, x)[0]


def cnn_loss(params: Mapping[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against integer labels."""
    logp = F.log_softmax(apply_cnn(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y.long()[:, None]))


@torch.no_grad()
def accuracy(
    params: Mapping[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor, batch_size: int = 2048
) -> torch.Tensor:
    """Full-dataset accuracy over fixed-size chunks; the tail chunk is padded
    (label −1, never counted), so every forward pass has one shape."""
    n = x.shape[0]
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, n, batch_size):
        xc, yc = x[start : start + batch_size], y[start : start + batch_size]
        pad = batch_size - xc.shape[0]
        if pad:
            xc = F.pad(xc, (0, 0) * (x.ndim - 1) + (0, pad))
            yc = F.pad(yc, (0, pad), value=-1)
        pred = torch.argmax(apply_cnn(params, xc), dim=-1)
        correct += torch.sum((pred == yc) & (yc >= 0))
    return correct / n
