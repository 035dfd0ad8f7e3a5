"""Package rules of the port: it imports neither JAX nor the JAX package,
and its entry points run on ``cuda`` unless the caller asks for the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import trainer as ttrainer  # noqa: E402
from repro_torch.kernels.gram import ops as tgram  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (
    sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("torch_*.py"))
)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def _tiny_trainer(device=None):
    cfg = tengine.FLConfig(num_clients=3, clients_per_round=2, rounds=1, eval_every=1)
    xs = np.zeros((3, 2, 28, 28, 1), np.float32)
    ys = np.zeros((3, 2), np.int32)
    params = tcnn.init_cnn(torch.Generator().manual_seed(0), channels=(2, 2), fc1_dim=4)
    return ttrainer.FLTrainer(
        cfg, params, tcnn.cnn_loss, tcnn.apply_with_features, xs, ys,
        tsel.make_strategy("fedavg"), device=device,
    )


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = torch.ones(4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgram.kernel_from_profiles(f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgram.kernel_from_profiles(f, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny_trainer()
    assert tgram.kernel_from_profiles(f, device="cpu").shape == (4, 4)
    hist = _tiny_trainer("cpu").run()
    assert hist["round"] == [1] and np.isfinite(hist["loss"]).all()


def test_paper_config_builds_the_kernel_through_k1_k2(monkeypatch):
    """The config as it stands routes the eq.-(14) kernel through the
    K1 + K2 pipeline (on the card, the kernels; here, their plain versions)."""
    from repro_torch.configs import paper_cnn

    calls = []
    pipeline = tgram.kernel_from_profiles

    def counting(f, device=None):
        calls.append(f.device.type)
        return pipeline(f, device=device)

    monkeypatch.setattr(tgram, "kernel_from_profiles", counting)
    assert paper_cnn.fl_config(paper_cnn.paper_scale()).use_pallas_kernel
    assert tengine.FLConfig().use_pallas_kernel
    _tiny_trainer("cpu")
    assert calls == ["cpu"]


def test_quickstart_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--rounds", "1", "--clients", "4", "--per-round", "2"])


@pytest.mark.parametrize(
    "field,value",
    [
        ("cohort_cap", 2), ("staleness_bound", 1),
    ],
)
def test_flconfig_refuses_features_not_yet_ported(field, value):
    """The client mesh's fields are ported: FLConfig takes them with JAX's
    checks (staleness needs a latency scenario).  The name dates from when
    FLConfig refused these fields."""
    assert getattr(tengine.FLConfig(**{field: value, "scenario": "heavy_tail"}), field) == value
    if field == "staleness_bound":
        with pytest.raises(ValueError, match="requires a latency scenario"):
            tengine.FLConfig(**{field: value})
