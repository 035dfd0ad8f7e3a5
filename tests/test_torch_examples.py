"""The port's four examples (``examples/torch_*.py``, counterparts of the
JAX package's ``examples/*.py``) run end to end on the CPU at their
smallest flags, each through its ``main``."""

import importlib
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture
def example(monkeypatch):
    """Imports an example module by name, as its own directory would."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    return importlib.import_module


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("algo", [[], ["--local-algo", "fedprox", "--prox-mu", "0.01"]], ids=["fedavg", "fedprox"])
def test_quickstart(example, capsys, algo):
    """FL-DP³S and FedAvg as one ``run_many`` grid: a history each, the
    final round evaluated off the ``eval_every`` grid."""
    results = example("torch_quickstart").main(
        ["--rounds", "2", "--clients", "4", "--per-round", "2", "--device", "cpu"] + algo)
    assert set(results) == {"fl-dp3s", "fedavg"}
    for hist in results.values():
        assert hist["round"] == [2] and 0.0 <= hist["acc"][-1] <= 1.0 and math.isfinite(hist["loss"][-1])
    assert capsys.readouterr().out.count("== ") == 2


def test_selection_ablation(example, capsys):
    """Every strategy with a pure draw, one grid: a row each."""
    mod = example("torch_selection_ablation")
    rows = mod.main(["--rounds", "2", "--clients", "4", "--per-round", "2", "--seeds", "1", "--device", "cpu"])
    assert list(rows) == list(mod.METHODS)
    for acc, gemd, rtt in rows.values():
        assert 0.0 <= acc <= 1.0 and 0.0 <= gemd <= 2.0 and rtt == 2.0
    assert "rounds to acc>=0.6" in capsys.readouterr().out


def test_serve_batched(example):
    """The serve launcher's legacy loop over the three families."""
    out = example("torch_serve_batched").main(["--batch", "1", "--prompt-len", "3", "--gen", "2", "--device", "cpu"])
    assert list(out) == ["smollm-360m", "rwkv6-7b", "recurrentgemma-9b"]
    assert all(isinstance(t, np.ndarray) and t.shape == (1, 2) for t in out.values())


def test_train_fl_llm(example, capsys):
    """The train launcher, FL-DP³S then FedAvg, on the same corpora."""
    out = example("torch_train_fl_llm").main(
        ["--rounds", "1", "--clients", "10", "--per-round", "2", "--seq", "8", "--log-every", "1", "--device", "cpu"])
    assert list(out) == ["fl-dp3s", "fedavg"]
    for state, outs in out.values():
        assert outs["selected"].shape == (1, 2) and bool(torch.isfinite(outs["loss"]).all())
    text = capsys.readouterr().out
    assert "[fl:fl-dp3s] round    1" in text and "[fl:fedavg] round    1" in text
