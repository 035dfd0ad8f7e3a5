import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: spawns subprocess dry-runs (512 host devices)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips without a card"
    )
