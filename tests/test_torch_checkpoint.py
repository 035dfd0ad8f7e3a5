"""The port's checkpoints: ``repro_torch.checkpoint`` against the JAX
package's contract and on-disk layout, and crash-resume through the port's
launcher, on the CPU.

The cases of JAX's ``tests/test_checkpoint.py`` (round trip, latest step,
and the refusals of a snapshot that does not match its template in leaf
count, shape or dtype, against both ``tree.json`` and the template), bf16
leaves stored as their 16-bit pattern, a JAX snapshot read into the port's
template, and ``test_launch_drivers.py::test_fl_driver_faults_and_crash_resume``
against ``repro_torch.launch.train`` with ``--device cpu``: the relaunch
resumes from the latest snapshot and ends where an uninterrupted run does,
bit for bit."""

import argparse
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jcheckpoint  # noqa: E402

from repro_torch import checkpoint  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones((4,), dtype=torch.float32),
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_roundtrip(tmp_path):
    tree = _tree()
    path = checkpoint.save(str(tmp_path), 3, tree)
    assert os.path.isdir(path) and path.endswith("step_00000003")
    assert sorted(os.listdir(path)) == ["arrays.npz", "tree.json"]
    out = checkpoint.restore(str(tmp_path), tree)
    assert list(out) == list(tree)
    for n in tree:
        assert isinstance(out[n], torch.Tensor) and out[n].dtype == tree[n].dtype and torch.equal(out[n], tree[n])


def test_latest_step(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None
    tree = _tree()
    checkpoint.save(str(tmp_path), 2, tree)
    checkpoint.save(str(tmp_path), 10, tree)
    (tmp_path / "step_x").mkdir()
    assert checkpoint.latest_step(str(tmp_path)) == 10
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), tree)


def test_restore_rejects_leaf_count_mismatch(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros((3, 4))})


def test_restore_rejects_shape_mismatch(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), dict(_tree(), w=torch.zeros((4, 3))))  # same size


def test_restore_rejects_dtype_mismatch(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.restore(str(tmp_path), dict(_tree(), b=torch.ones((4,), dtype=torch.int32)))


@pytest.mark.parametrize("edit", ["num_leaves", "shape", "dtype"])
def test_restore_rejects_corrupt_meta(tmp_path, edit):
    """``tree.json`` disagreeing with ``arrays.npz`` is corruption even
    when the arrays match the template."""
    tree = _tree()
    path = checkpoint.save(str(tmp_path), 1, tree)
    meta_path = os.path.join(path, "tree.json")
    with open(meta_path) as f:
        meta = json.load(f)
    if edit == "num_leaves":
        meta["num_leaves"] = 99
    elif edit == "shape":
        meta["shapes"][0] = [999]
    else:
        meta["dtypes"][0] = "bfloat16"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        checkpoint.restore(str(tmp_path), tree)


def test_bf16_leaves_round_trip_as_their_bit_pattern(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"emb": torch.randn((5, 3), generator=g).to(torch.bfloat16), "blocks": [
        {"w": torch.randn((2, 2), generator=g).to(torch.bfloat16), "n": torch.ones(2)}]}
    path = checkpoint.save(str(tmp_path), 4, tree)
    with open(os.path.join(path, "tree.json")) as f:
        assert json.load(f)["dtypes"] == ["bfloat16", "bfloat16", "float32"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z["leaf_0"].dtype == np.int16
    out = checkpoint.restore(str(tmp_path), tree)
    assert out["emb"].dtype == torch.bfloat16 and torch.equal(out["emb"], tree["emb"])
    assert torch.equal(out["blocks"][0]["w"], tree["blocks"][0]["w"]) and isinstance(out["blocks"], list)
    # the logical dtype is checked: an int16 or fp16 template is another config
    for dtype in (torch.int16, torch.float16):
        other = dict(tree, emb=tree["emb"].to(dtype))
        with pytest.raises(ValueError, match="dtype"):
            checkpoint.restore(str(tmp_path), other)


def test_none_leaves_named_tuples_and_arrays(tmp_path):
    params = {"w": torch.ones(3)}
    opt = topt.adam(1e-3)
    tree = {"params": params, "opt": opt.init(params), "absent": None, "arr": np.arange(4, dtype=np.int64)}
    checkpoint.save(str(tmp_path), 1, tree)
    out = checkpoint.restore(str(tmp_path), tree)
    assert out["absent"] is None and isinstance(out["opt"], topt.AdamState)
    assert isinstance(out["arr"], np.ndarray) and np.array_equal(out["arr"], tree["arr"])
    assert torch.equal(out["opt"].step, tree["opt"].step) and out["opt"].step.dtype == torch.int32


def test_jax_snapshot_reads_into_the_port(tmp_path):
    """The same layout: a snapshot of the JAX package (its dict keys
    flattened in sorted order) restores into a port template whose keys are
    in that order, and the port's snapshot of it records the same shapes
    and dtypes."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(2, 3)).astype(np.float32), "b": np.arange(5, dtype=np.int32),
            "c": np.array(True)}
    jcheckpoint.save(str(tmp_path / "jax"), 5, jax.tree_util.tree_map(jnp.asarray, tree))
    template = {n: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for n, v in tree.items()}
    out = checkpoint.restore(str(tmp_path / "jax"), template)
    for n, v in tree.items():
        np.testing.assert_array_equal(out[n].numpy(), v)
    checkpoint.save(str(tmp_path / "port"), 5, out)
    metas = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "step_00000005" / "tree.json") as f:
            metas.append(json.load(f))
    for key in ("step", "num_leaves", "shapes", "dtypes"):
        assert metas[0][key] == metas[1][key], key


# ------------------------------------------------------------- launcher


@pytest.fixture
def one_thread():
    """The launcher tests run a small transformer on the CPU: one intra-op
    thread keeps them from contending for the cores with the other test
    workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _args(**kw):
    base = dict(
        arch="smollm-360m", mode="fl", selection="fedavg", rounds=2, steps=3, clients=6, per_round=3,
        docs_per_client=4, local_steps=1, local_batch=2, seq=16, lr=1e-3, seed=0, log_every=100,
        device="cpu", full_width=False, layers=None, flash=False, shard_clients=0, cohort_cap=None,
        scenario=None, staleness_bound=None, staleness_decay="polynomial", staleness_alpha=0.5,
        candidate_frac=None,
        faults=None, aggregator="mean", local_algo="fedavg", prox_mu=None, feddyn_alpha=None,
        ckpt_every=None, ckpt=None, telemetry=None, profile_dir=None,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def test_fl_launcher_faults_and_crash_resume(tmp_path, capsys, one_thread):
    """``--faults``/``--aggregator`` drive the guarded engine; with
    ``--ckpt-every`` and ``--ckpt`` a second launch resumes from the latest
    snapshot, runs only the rounds left, and ends where one uninterrupted
    launch of all the rounds ends: params, losses and generators bit for
    bit."""
    kw = dict(faults="corrupt", aggregator="trimmed_mean", ckpt_every=1, local_algo="feddyn", feddyn_alpha=0.1)
    ck = str(tmp_path / "ck")
    ttrain.run_fl(_args(rounds=2, ckpt=ck, **kw))
    first = capsys.readouterr().out
    assert "faults=corrupt aggregator=trimmed_mean" in first and "resumed" not in first
    assert sorted(os.listdir(ck)) == ["step_00000001", "step_00000002"]
    state, outs = ttrain.run_fl(_args(rounds=3, ckpt=ck, **kw))
    out = capsys.readouterr().out
    assert f"resumed round 2 from {ck}/step_00000002" in out
    assert sorted(os.listdir(ck))[-1] == "step_00000003" and outs["round"].tolist() == [3]
    full, full_outs = ttrain.run_fl(_args(rounds=3, ckpt=str(tmp_path / "full"), **kw))
    assert state.round == full.round == 3
    assert _trees_equal(state.params, full.params) and _trees_equal(state.algo_state, full.algo_state)
    assert torch.equal(state.losses, full.losses) and torch.equal(state.quarantine, full.quarantine)
    for g in ("generator", "fault_generator"):
        assert torch.equal(getattr(state, g).get_state(), getattr(full, g).get_state())
    assert torch.equal(outs["selected"], full_outs["selected"][2:])
    # all rounds done: a third launch resumes and runs none
    _, done = ttrain.run_fl(_args(rounds=3, ckpt=ck, **kw))
    assert done == {} and "resumed round 3" in capsys.readouterr().out


def test_ckpt_without_every_saves_the_final_params(tmp_path, capsys, one_thread):
    ck = str(tmp_path / "ck")
    state, _ = ttrain.run_fl(_args(rounds=1, ckpt=ck))
    assert f"checkpoint -> {ck}" in capsys.readouterr().out
    assert os.listdir(ck) == ["step_00000001"]
    assert _trees_equal(checkpoint.restore(ck, state.params), state.params)


def test_pretrain_ckpt_saves_params_and_optimizer(tmp_path, capsys, one_thread):
    ck = str(tmp_path / "ck")
    params, opt_state, _ = ttrain.run_pretrain(_args(mode="pretrain", steps=2, local_batch=2, log_every=1, ckpt=ck))
    assert f"checkpoint -> {ck}" in capsys.readouterr().out
    out = checkpoint.restore(ck, {"params": params, "opt": opt_state}, step=2)
    assert int(out["opt"].step) == 2
    assert _trees_equal(out, {"params": params, "opt": opt_state})


def test_launcher_flag_contract(tmp_path):
    with pytest.raises(SystemExit, match="--ckpt-every requires --ckpt"):
        ttrain.main(["--mode", "fl", "--ckpt-every", "2", "--device", "cpu"])
    for flag, value in (("--faults", "corrupt"), ("--aggregator", "trimmed_mean"), ("--local-algo", "feddyn"),
                        ("--prox-mu", "0.1"), ("--feddyn-alpha", "0.1"), ("--ckpt-every", "2")):
        with pytest.raises(ValueError, match=f"{flag} select federation features"):
            ttrain.main(["--mode", "pretrain", flag, value, "--device", "cpu"])
    for flag, value in (("--faults", "nope"), ("--aggregator", "median"), ("--local-algo", "scaffold")):
        with pytest.raises(SystemExit):  # argparse: not one of the choices
            ttrain.main(["--mode", "fl", flag, value, "--device", "cpu"])
    with pytest.raises(ValueError, match="only applies to local_algo='fedprox'"):
        ttrain.run_fl(_args(prox_mu=0.1))
