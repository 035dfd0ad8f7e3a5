"""The paper's own experimental configuration (§4).

CNN: two conv layers + two fully-connected layers; C = 100 clients,
C_p = 10 per round, MNIST/Fashion-MNIST-scale data (60k samples, 10 classes,
28×28), skewness ξ ∈ {0.5, 0.8, 'H', 1}.  ``bench_scale()`` is the smaller
variant of the JAX package's benchmark harness (same protocol, smaller round
count / client datasets).
"""

from __future__ import annotations

import dataclasses

from repro_torch.fl.engine import FLConfig


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    num_clients: int = 100
    clients_per_round: int = 10
    samples_per_client: int = 600
    local_epochs: int = 2
    lr: float = 0.05
    rounds: int = 300
    eval_every: int = 5
    seeds: int = 50
    cnn_channels: tuple = (16, 32)
    fc1_dim: int = 128


def paper_scale() -> PaperExperiment:
    return PaperExperiment()


def bench_scale() -> PaperExperiment:
    """Smaller protocol: same C/C_p ratio and selection mechanics."""
    return PaperExperiment(
        num_clients=40,
        clients_per_round=10,
        samples_per_client=60,
        local_epochs=2,
        lr=0.08,
        rounds=30,
        eval_every=3,
        seeds=1,
        cnn_channels=(8, 16),
        fc1_dim=64,
    )


def fl_config(exp: PaperExperiment, seed: int = 0) -> FLConfig:
    return FLConfig(
        num_clients=exp.num_clients,
        clients_per_round=exp.clients_per_round,
        local_epochs=exp.local_epochs,
        lr=exp.lr,
        rounds=exp.rounds,
        eval_every=exp.eval_every,
        seed=seed,
    )
