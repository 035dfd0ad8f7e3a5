"""The port's sharded dry run (``repro_torch.launch.dryrun`` on the
production meshes, a ``fake`` process group in which this process is rank
0) on the CPU.

On a (1, 1) mesh the sharded path is the one-card path: FLOPs, bytes,
peak and kernel calls equal.  Reduced Mode-A, Mode-B and decode cases are
``ok`` on both production meshes, every collective over an axis of more
than one device; rank 0's program run on real CPU tensors made at its
shapes counts the record's FLOPs and collectives.  The port partitions
with DTensor where JAX partitions with GSPMD, so collective bytes are
printed beside JAX's reduced dry run's (a subprocess: ``repro.launch.
dryrun`` forces 512 host devices), with no bound.  ``--fl-sharded``'s six
cases run on gloo thread ranks."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.ops import StepCounter, collective_bytes, tensor_bytes  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import release_fake_meshes  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EQUAL_KEYS = ("flops", "bytes_moved", "peak_bytes", "kernel_calls", "kernel_flops", "argument_bytes")


@pytest.fixture(autouse=True, scope="module")
def own_fake_group():
    """The fake meshes' default group lives only while this file runs: other
    files in the same worker hold process groups of their own."""
    yield
    release_fake_meshes()


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch,shape,kw", [
    ("smollm-360m", "train_4k", dict(clients=2, local_steps=1)),
    ("llama4-maverick-400b-a17b", "train_4k", {}),
    ("mixtral-8x7b", "prefill_32k", {}),
    ("smollm-360m", "decode_32k", {}),
    ("rwkv6-7b", "decode_32k", {}),
])
def test_one_by_one_mesh_equals_one_card(arch, shape, kw):
    """Every DTensor replicated (an axis of one device cuts nothing): the
    record's FLOPs, bytes moved, peak, arguments and kernel calls (K5 and
    K7 through their wrappers) are the one-card record's, and no
    collective runs."""
    one = D.run_case(D.DryRunCase(arch, shape, reduced=True, **kw))
    mesh = D.run_case(D.DryRunCase(arch, shape, reduced=True, mesh_shape=(1, 1), **kw))
    assert one["ok"] and mesh["ok"], mesh.get("traceback")
    assert {k: mesh[k] for k in EQUAL_KEYS} == {k: one[k] for k in EQUAL_KEYS}
    assert (one["mesh"], mesh["mesh"], mesh["collectives"]["total"], mesh["t_collective"]) == ("1", "1x1", 0.0, 0.0)


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("smollm-360m", "train_4k", False),  # Mode A: the clients over the data axes
    ("smollm-360m", "train_4k", True),
    ("llama4-maverick-400b-a17b", "train_4k", False),  # Mode B: FSDP rules, Adafactor, the batch over data
    ("rwkv6-7b", "decode_32k", False),  # serving: caches by their specs, K7 through local_map
    ("rwkv6-7b", "decode_32k", True),
])
def test_reduced_cases_on_the_production_meshes(arch, shape, multi_pod):
    """``ok`` with one device's counts: arguments below the one-card
    record's, collectives only over axes of more than one device (the
    mesh's own axes), the three roofline terms, and the fit.  (Mode B on
    the 2 x 16 x 16 mesh takes ~40 s of DTensor's first plans for it in a
    process: the reduced sweep, ``--both-meshes``, runs it.)"""
    kw = dict(local_steps=1) if arch == "smollm-360m" else {}
    rec = D.run_case(D.DryRunCase(arch, shape, reduced=True, multi_pod=multi_pod, **kw))
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16") and rec["devices"] == (512 if multi_pod else 256)
    axes = set(rec["collectives"]["by_axis"])
    assert axes and axes <= ({"pod", "data", "model"} if multi_pod else {"data", "model"}), axes
    assert rec["collectives"]["total"] == sum(rec["collectives"]["by_kind"].values()) > 0
    assert rec["t_collective"] > 0 and rec["t_compute"] > 0 and rec["t_memory"] > 0 and rec["fits_one_card"]
    one = D.arguments(D.DryRunCase(arch, shape, reduced=True, **kw))
    assert 0 < rec["argument_bytes"] < one["argument_bytes"]
    if arch == "rwkv6-7b":
        assert rec["kernel_calls"]["wkv6"] == 2  # K7 once a layer, at each device's rows


def test_sequence_sharded_cache_decodes_on_the_plain_path():
    """The serve rules shard the KV cache's sequence over ``model`` (K5's
    reduced axis): the sharded decode takes the plain attention and K5 is
    called never; with the sequence left whole, K5 runs on each device's
    rows through ``local_map``, its fake call at the local batch."""
    sharded = D.run_case(D.DryRunCase("smollm-360m", "decode_32k", reduced=True, multi_pod=False))
    assert sharded["decode_attention"] == "plain" and sharded["kernel_calls"]["flash_decode"] == 0
    whole = D.run_case(D.DryRunCase("smollm-360m", "decode_32k", reduced=True, multi_pod=False,
                                    rules_s={"cache_seq": None}))
    assert whole["ok"] and whole["decode_attention"] == "flash_decode"
    assert whole["kernel_calls"]["flash_decode"] == 2  # a layer each
    one = D.run_case(D.DryRunCase("smollm-360m", "decode_32k", reduced=True))
    assert whole["kernel_flops"]["flash_decode"] == one["kernel_flops"]["flash_decode"] / 16  # 1 of 16 rows


def test_rank0_program_on_real_tensors_counts_the_record():
    """The card's check (``chip_smoke.py`` phase 8b) on the CPU: rank 0's
    decode step on real tensors made at its shapes (``materialize``)
    counts the record's FLOPs, arguments and collectives kind by kind."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    case = D.DryRunCase("smollm-360m", "decode_32k", reduced=True, multi_pod=False)
    rec = D.run_case(case)
    mesh = D.case_mesh(case)
    with FakeTensorMode():
        step, fake_args, _ = D.build_sharded_step(case, mesh, "cpu")
    args = D.materialize(fake_args, "cpu")
    counter = StepCounter(mesh)
    counter.hold(args)
    with counter:
        logits, _ = step(*args)
    assert counter.flops == rec["flops_counted"]
    assert sum(tensor_bytes(x) for x in tree_leaves(args)) == rec["argument_bytes"]
    assert collective_bytes(counter.collectives)["calls"] == rec["collectives"]["calls"]
    assert tuple(logits.to_local().shape) == (1, 1, 32)  # this rank's row, its 32 of the 512 logits (vocab_w: model)


def test_collective_bytes_beside_jax(capsys):
    """Printed, not bounded: the port's per-device collective bytes by kind
    beside JAX's ``collective_bytes`` of its own reduced dry run of the
    same case on the 16 x 16 mesh."""
    rec = D.run_case(D.DryRunCase("smollm-360m", "decode_32k", reduced=True, multi_pod=False))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = os.path.join(ROOT, "build", f"jax_dryrun_{os.getpid()}.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    try:
        subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", "smollm-360m", "--shape",
                        "decode_32k", "--reduced", "--out", out], env=env, cwd=ROOT, check=True,
                       capture_output=True, timeout=600)
        (jrec,) = [json.loads(line) for line in open(out)]
    finally:
        if os.path.exists(out):
            os.remove(out)
    assert rec["ok"] and jrec["ok"]
    with capsys.disabled():
        print(f"\nsmollm-360m decode_32k reduced, 16x16, per device: port (DTensor) {rec['collectives']['by_kind']}"
              f" B; JAX (GSPMD) {jrec['collectives']} B")


def test_fl_sharded_six_cases(capsys):
    """``--fl-sharded``: JAX's six variants on the port's engine over two
    gloo thread ranks, each ``ok`` with one all-reduce a round."""
    recs = D.run_fl_sharded_cases(devices=2, clients=32, rounds=2)
    assert [r["case"] for r in recs] == [
        "fl_sharded_engine", "fl_sharded_engine_slotted", "fl_sharded_engine_stale", "fl_sharded_engine_funnel",
        "fl_sharded_engine_faulty", "fl_sharded_engine_feddyn"]
    for r in recs:
        assert r["ok"], r.get("traceback", r.get("error"))
        assert r["all_reduces_per_round"] == 1 and r["all_reduce_bytes_per_round"] > 0
        assert (r["backend"], r["mesh"]) == ("gloo", "2x1(clients)")
    assert recs[3]["candidates"] == 16


def test_cli_mesh_flags(tmp_path, capsys):
    """``--both-meshes`` writes one ``ok`` record a mesh, ``--multi-pod``
    the 2 x 16 x 16 one, and a second run skips what is in ``--out``."""
    out = tmp_path / "d.jsonl"
    D.main(["--arch", "smollm-360m", "--shape", "long_500k", "--reduced", "--both-meshes", "--out", str(out)])
    D.main(["--arch", "granite-3-2b", "--shape", "long_500k", "--reduced", "--multi-pod", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["mesh"], r["ok"]) for r in recs] == [
        ("smollm-360m", "16x16", True), ("smollm-360m", "2x16x16", True), ("granite-3-2b", "2x16x16", True)]
    D.main(["--arch", "smollm-360m", "--shape", "long_500k", "--reduced", "--both-meshes", "--out", str(out)])
    assert capsys.readouterr().out.count("[skip]") == 2


# ------------------------------------------------ a real 2 x 2 gloo mesh

FP32 = dict(dtype="float32", param_dtype="float32")


def _close(name, got, want, tol):
    """``got`` (a DTensor, gathered) within ``tol`` of ``want`` relative to
    ``want``'s largest magnitude."""
    got = got.full_tensor() if sh.is_dtensor(got) else got
    err = float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)
    assert err <= tol, f"{name}: {err:.3e} > {tol:.0e}"
    return err


def _mesh_rank(rank: int, init_file: str) -> None:
    """Rank ``rank`` of a real 2 x 2 (data, model) gloo mesh: the sharded
    dry run's steps on real fp32 tensors, laid out by the rules, against
    the unsharded path on the same inputs (every rank checks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        kw = dict(reduced=True, mesh_shape=(2, 2), cfg_over=FP32, batch=4)

        # serving: a prefill that fills the sequence-sharded caches (every
        # device's slots written), then a decode step that writes one slot
        pre = D.DryRunCase("smollm-360m", "prefill_32k", **kw)
        dec = D.DryRunCase("smollm-360m", "decode_32k", **kw)
        step, args, _ = D.build_sharded_step(pre, mesh)
        pstep, pargs, _ = D.build_step(pre)
        logits, caches = step(*args)
        plogits, pcaches = pstep(*pargs)
        assert any(p.is_shard(1) for p in caches["unit"][0]["k"].placements)  # cache_seq over model
        _close("prefill logits", logits, plogits, 1e-5)
        for a, b in zip(tree_leaves(caches), tree_leaves(pcaches)):
            _close("prefill cache", a, b, 1e-5)
        step, args, _ = D.build_sharded_step(dec, mesh)
        pstep, pargs, _ = D.build_step(dec)
        logits, caches = step(args[0], args[1], caches)
        plogits, pcaches = pstep(pargs[0], pargs[1], pcaches)
        _close("decode logits", logits, plogits, 1e-5)
        for a, b in zip(tree_leaves(caches), tree_leaves(pcaches)):
            _close("decode cache", a, b, 1e-5)

        # Mode B (llama4: the MoE's pending slot sums, the vocab-parallel
        # embedding and gold logits, micro-batches of each device's rows):
        # the unsharded step takes the same micro-batches, the batch's rows
        # ordered as the devices' i-th slices
        train = D.DryRunCase("llama4-maverick-400b-a17b", "train_4k", **kw)
        step, args, _ = D.build_sharded_step(train, mesh)
        pstep, pargs, info = D.build_step(train, micro_rows=2)
        assert info["micro_batches"] == 2
        perm = [dev * 2 + i for i in range(2) for dev in range(2)]
        params, _, loss = step(*args)
        pparams, _, ploss = pstep(pargs[0], pargs[1], tuple(x[perm] for x in pargs[2]))
        _close("Mode-B loss", loss, ploss, 1e-5)
        for a, b in zip(tree_leaves(params), tree_leaves(pparams)):
            _close("Mode-B params", a, b, 1e-5)
    finally:
        dist.destroy_process_group()


def test_real_two_by_two_mesh_equals_the_unsharded_path(tmp_path):
    """Four spawned processes, a real 2 x 2 gloo mesh: smollm-360m's
    prefill and decode (the caches' sequence sharded over ``model``, each
    device writing only its own slots) and llama4-maverick's Mode-B step
    equal the unsharded path within fp32 rounding (1e-5 of each tensor's
    largest magnitude): logits, every cache leaf, the loss and the
    updated params."""
    import torch.multiprocessing as mp

    mp.start_processes(_mesh_rank, args=(str(tmp_path / "init"),), nprocs=4, join=True, start_method="spawn")
