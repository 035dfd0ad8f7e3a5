"""The port's dry run (``repro_torch.launch.dryrun``) and FedOpt
(``fl/rounds.build_server_opt_round``) against the JAX package on the CPU.

The dry run's arguments equal the JAX dry run's abstract trees (computed
here with ``jax.eval_shape``, never by importing ``repro.launch.dryrun``,
which forces 512 host devices); its fake counts equal the same step run on
real CPU tensors op for op (FLOPs also by ``FlopCounterMode`` itself); the
extrapolation over repeat units equals the direct count; the CLI's records,
refusals and the serving engine's shape signatures."""

import collections
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.fl import rounds as jrounds  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch import optim as toptim  # noqa: E402
from repro_torch.analysis.ops import StepCounter  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.fl import rounds as trounds  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import release_fake_meshes  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

COUNT_KEYS = ("flops", "bytes_moved", "step_peak", "output_bytes", "ops", "kernel_calls", "kernel_flops",
              "kernel_bytes")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_input_shapes_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}


# ------------------------------------------------- arguments against JAX


def _nbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree))


def _jax_arguments(arch: str, shape: str):
    """(params, argument bytes) of the JAX dry run's step at full width:
    ``jax.eval_shape`` of ``init_params``, the Mode-B optimizer state and
    the caches, and the batch and client weights of ``_train_case`` and
    ``_serve_case`` on the single-pod mesh (16 clients)."""
    spec = jget_arch(arch)
    ishape = J_INPUT_SHAPES[shape]
    cfg = spec.long_context_model() if shape == "long_500k" else spec.model
    b, s = ishape.global_batch, ishape.seq_len
    params = jax.eval_shape(lambda k: jT.init_params(k, cfg), jax.random.key(0))
    n = _nbytes(params)
    vlm = cfg.arch_type == "vlm"
    if ishape.kind == "train":
        if spec.fl.mode == "client_parallel":
            rows = 16 * spec.fl.local_steps * max(1, b // 16)
            n += 16 * 4  # client weights, fp32
        else:
            opt = getattr(joptim, spec.optimizer)(spec.fl.lr)
            n += _nbytes(jax.eval_shape(opt.init, params))
            rows = b
        n += rows * s * (cfg.d_model * 2 + 4 if vlm else 4)  # bf16 embeds + int32 targets, or int32 tokens
    else:
        n += _nbytes(jax.eval_shape(lambda: jT.init_caches(cfg, b, s)))
        if ishape.kind == "prefill":
            n += b * s * (cfg.d_model * 2 if vlm else 4)
        else:
            n += b * 4
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params)), n


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_and_argument_bytes_equal_jax_eval_shape(arch):
    """All four shapes at full width: the parameter count and the bytes of
    params, optimizer state, batch, weights and caches."""
    for shape in INPUT_SHAPES:
        got = D.arguments(D.DryRunCase(arch, shape))
        assert (got["params"], got["argument_bytes"]) == _jax_arguments(arch, shape), (arch, shape)


# ------------------------------------------------- fake against real


def _real_counts(case: D.DryRunCase):
    """The case's step on real CPU tensors, counted by ``StepCounter`` and
    by ``FlopCounterMode`` itself."""
    from torch.utils.flop_counter import FlopCounterMode

    step, args, _ = D.build_step(case, "cpu")
    counter, fc = StepCounter(), FlopCounterMode(display=False)
    counter.hold(args)
    with fc, counter:
        out = step(*args)
    return counter, fc.get_total_flops(), out


# Fake tensors and the CPU kernels may spell a view differently (a strided
# slice's backward is as_strided on one side and slice on the other), and
# give a size-1 dim another stride, so that ``matmul`` folds a product to
# mm on one side and runs it as bmm on the other.  Views move no bytes and
# hold no storage, and mm and bmm do the same FLOPs on the same bytes, so
# the histograms are compared without views and with mm and bmm as one.
# The MoE FFN is the one place where fake tensors take another form of the
# same ops: ``F.one_hot`` (the router's aux loss) validates its input on a
# real tensor (aminmax and a host read, then zeros + scatter_) and is
# arange + eq on a fake one; there the histograms are held equal outside
# these ops, and bytes and peak within 1%.
MOE_FORMS = {"aten._local_scalar_dense", "aten.aminmax", "aten.scatter_", "aten.zeros", "aten.arange", "aten.eq",
             "aten._to_copy"}


def _is_view(name: str) -> bool:
    packet = getattr(torch.ops.aten, name.split(".", 1)[1])
    return any(getattr(packet, o).is_view for o in packet.overloads())


def _assert_same_counts(arch: str, fake: dict, counter: StepCounter, fc_flops: float):
    assert fake["flops"] == counter.flops == fc_flops > 0
    moe = bool(get_arch(arch).model.num_experts)

    def strip(ops):
        out = collections.Counter()
        for k, v in ops.items():
            if not _is_view(k) and not (moe and k in MOE_FORMS):
                out["aten.mm|bmm" if k in ("aten.mm", "aten.bmm") else k] += v
        return out

    assert strip(fake["ops"]) == strip(dict(counter.ops))
    if moe:
        np.testing.assert_allclose(fake["bytes_moved"], counter.bytes_moved, rtol=1e-2)
        np.testing.assert_allclose(fake["step_peak"], counter.peak, rtol=1e-2)
        return
    assert (fake["bytes_moved"], fake["step_peak"]) == (counter.bytes_moved, counter.peak)


TRAIN_ARCHS = ("smollm-360m", "qwen2-vl-2b", "musicgen-medium", "mixtral-8x7b", "recurrentgemma-9b",
               "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fake_train_step_counts_equal_a_real_cpu_run(arch):
    """The reduced train_4k step (Mode A with 2 clients, or llama4's Mode B
    with Adafactor): fake counts, with the gradient memo replaying every
    later micro-batch, equal the real run's op for op: the histogram, FLOPs
    (= FlopCounterMode's), bytes moved, the peak above the arguments."""
    case = D.DryRunCase(arch, "train_4k", reduced=True, clients=2)
    fake = D.count_step(case)
    assert fake["grads_replayed"] > 0 and fake["grads_counted"] == 1
    counter, fc_flops, out = _real_counts(case)
    assert all(np.isfinite(float(x)) for x in tree_leaves(out) if x.ndim == 0)
    _assert_same_counts(arch, fake, counter, fc_flops)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_fake_serve_step_counts_equal_a_real_cpu_run(arch, shape):
    """The reduced serving steps on the plain path (every op runs on both
    sides): equal op for op."""
    case = D.DryRunCase(arch, shape, reduced=True, use_flash=False)
    fake = D.count_step(case)
    counter, fc_flops, _ = _real_counts(case)
    _assert_same_counts(arch, fake, counter, fc_flops)
    assert not any(fake["kernel_calls"].values())


def test_grad_memo_replays_unused_params_as_zero_gradients():
    """A loss that reads one of two params (RWKV's ``mu_x`` is such a
    leaf): counted with the memo (one gradient taken, two replayed) and
    without it, the step's ops, FLOPs, bytes and peak are the same, and
    the unread param's gradient is zeros of its shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.fl.local_algos import make_grad_fn

    def loss(p, batch):
        return torch.sum((batch[0] @ p["a"]) ** 2)

    def run(memoize):
        with FakeTensorMode():
            counter = StepCounter()
            memo = D._GradMemo(counter)
            grad_fn = make_grad_fn(memo.wrap(loss) if memoize else loss, micro_batches=3)
            params = {"a": torch.ones(8, 4), "b": torch.ones(5)}
            batch = (torch.ones(6, 2, 8),)
            counter.hold((params, batch))
            with counter:
                _, g = grad_fn(params, batch)
                _, g = grad_fn(params, batch)
            assert tuple(g["b"].shape) == (5,)
            return counter, memo

    (c1, m1), (c0, _) = run(True), run(False)
    assert (m1.real, m1.replayed) == (1, 5)
    assert dict(c1.ops) == dict(c0.ops) and c1.ops["aten.zeros_like"] == 6
    assert (c1.flops, c1.bytes_moved, c1.peak) == (c0.flops, c0.bytes_moved, c0.peak)


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b", "musicgen-medium"])
def test_fake_kernel_calls_launch_nothing_and_count_analytically(arch):
    """Through K5 / K7: one fake call a layer, nothing in LAUNCHES.  K5's
    count is the plain version's matmul FLOPs (every slot against every
    cache entry), so the decode step's total equals the plain path's; K7's
    is the JAX package's 8·hd² a head and token."""
    cfg = D.case_config(D.DryRunCase(arch, "decode_32k", reduced=True))[1]
    _build.reset_launches()
    flash = D.count_step(D.DryRunCase(arch, "decode_32k", reduced=True))
    plain = D.count_step(D.DryRunCase(arch, "decode_32k", reduced=True, use_flash=False))
    assert not any(_build.LAUNCHES.values())
    kernel = "wkv6" if arch == "rwkv6-7b" else "flash_decode"
    assert flash["kernel_calls"][kernel] == cfg.num_layers
    total = flash["flops"] + sum(flash["kernel_flops"].values())
    if kernel == "flash_decode":
        assert total == plain["flops"]
    else:
        h = cfg.d_model // cfg.rwkv_head_dim
        assert flash["kernel_flops"]["wkv6"] == 8.0 * cfg.rwkv_head_dim**2 * h * 16 * 1 * cfg.num_layers


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "train_4k"), ("llama4-maverick-400b-a17b", "train_4k"), ("recurrentgemma-9b", "train_4k"),
    ("smollm-360m", "decode_32k"), ("rwkv6-7b", "prefill_32k"), ("recurrentgemma-9b", "prefill_32k"),
    ("mixtral-8x7b", "decode_32k"), ("gemma-7b", "long_500k"),
])
def test_extrapolation_over_repeat_units_equals_the_direct_count(arch, shape):
    """Counted at two and three units and extrapolated to four, every count
    equals the count of the four-unit step itself.  The peak is the most
    of several live totals, each affine in the units, so the line through
    two and three units is a lower bound of it (convexity); on these
    configs it is exact or within 2% (a reduced model's activations are
    small beside its parameters, so where the peak lies can move with the
    units; at full width smollm-360m's round is on the line from two to
    all 32 units: src/repro_torch/DESIGN.md)."""
    case = D.DryRunCase(arch, shape, reduced=True, clients=2)
    cfg = D.case_config(case)[1]
    D._warm(case)
    c2, c3 = (D._count(case, D._with_units(cfg, r)) for r in (2, 3))
    got = D._extrapolate(c2, c3, 4)
    got["ops"] = {k: v for k, v in got["ops"].items() if v}
    want = D._count(case, D._with_units(cfg, 4))
    for key in COUNT_KEYS:
        if key != "step_peak":
            assert got[key] == want[key], key
    assert 0.98 * want["step_peak"] <= got["step_peak"] <= want["step_peak"]


def test_scan_rounds_count_n_rounds():
    """``scan_rounds=2``: two Mode-A rounds in one step, their batches
    stacked on a leading axis: twice the FLOPs and the gradients of one."""
    one = D.run_case(D.DryRunCase("smollm-360m", "train_4k", reduced=True, clients=2))
    two = D.run_case(D.DryRunCase("smollm-360m", "train_4k", reduced=True, clients=2, scan_rounds=2))
    assert one["ok"] and two["ok"] and two["scan_rounds"] == 2
    assert two["flops"] == 2 * one["flops"]
    assert two["grads_counted"] + two["grads_replayed"] == 2 * (one["grads_counted"] + one["grads_replayed"])
    batch = 2 * 8 * 8 * 128 * 4  # clients x local steps x rows (16 // 2) x seq, int32
    assert two["argument_bytes"] - one["argument_bytes"] == batch


# ------------------------------------------------------------------ CLI


def test_cli_reduced_records_are_ok(tmp_path, capsys):
    out = tmp_path / "dryrun.jsonl"
    D.main(["--arch", "smollm-360m", "--shape", "train_4k", "--reduced", "--out", str(out)])
    D.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--reduced", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["ok"]) for r in recs] == [
        ("smollm-360m", "train_4k", True), ("rwkv6-7b", "decode_32k", True)]
    train, decode = recs
    assert (train["fl_mode"], train["clients"], train["local_steps"]) == ("client_parallel", 16, 8)
    assert train["flops"] > 0 and train["peak_bytes"] > train["argument_bytes"] > 0
    assert train["fits_one_card"] and train["cards_needed"] == 1 and train["card"] == "NVIDIA H100 80GB HBM3"
    assert decode["kernel_calls"]["wkv6"] == 2 and decode["ops"]
    # the cached case is skipped on a second run
    D.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--reduced", "--out", str(out)])
    assert "[skip]" in capsys.readouterr().out


@pytest.fixture
def fake_group():
    """The mesh flags' fake default group lives only while the test runs."""
    yield
    release_fake_meshes()


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes", "--fl-sharded"])
def test_cli_refuses_mesh_flags_naming_item_15(flag, tmp_path, monkeypatch, fake_group):
    """The mesh flags that ROADMAP Queue 1 item 15 once refused now run:
    each writes only ``ok`` records (reduced, small; ``--fl-sharded``'s
    federation cut to 16 clients and one round, its flags passed on)."""
    out = tmp_path / "d.jsonl"
    if flag == "--fl-sharded":
        full = D.run_fl_sharded_cases

        def small(devices, cohort_cap, staleness_bound, candidate_frac):
            assert (devices, cohort_cap, staleness_bound, candidate_frac) == (2, 2, 2, 0.25)
            return full(devices, cohort_cap, staleness_bound, candidate_frac, clients=16, rounds=1)

        monkeypatch.setattr(D, "run_fl_sharded_cases", small)
        extra = ["--fl-devices", "2"]
    else:
        extra = ["--arch", "smollm-360m", "--shape", "long_500k", "--reduced"]
    D.main([flag, "--out", str(out)] + extra)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs and all(r["ok"] for r in recs)
    assert len(recs) == {"--multi-pod": 1, "--both-meshes": 2, "--fl-sharded": 6}[flag]


def test_serve_engine_keeps_one_signature_per_entry_point(tmp_path):
    out = tmp_path / "engine.jsonl"
    D.main(["--serve-engine", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["arch"] for r in recs] == ["smollm-360m", "rwkv6-7b", "mixtral-8x7b"]
    for r in recs:
        assert r["ok"] and r["finished"] == 5, r
        assert r["compile_counts"] == {"decode_chunk": 1, "admit": 1}


def test_full_width_mode_b_record_reports_the_cards_it_needs():
    """llama4-maverick's Mode B step is far past one card; at one unit's
    cost the arguments alone (params and Adafactor's state) say so."""
    got = D.arguments(D.DryRunCase("llama4-maverick-400b-a17b", "train_4k"))
    assert (got["fl_mode"], got["optimizer"], got["micro_batches"]) == ("fedsgd_fsdp", "adafactor", 8)
    assert math.ceil(got["argument_bytes"] / (80 * 2**30)) > 1


# ------------------------------------------------------------ FedOpt


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_server_opt_round_matches_jax():
    """Two FedOpt rounds of the reduced smollm LM (2 clients, 2 local
    steps) with a server Adam of adaptivity 1e-3 (FedAdam's
    τ; with eps 1e-8 Adam's first step is sign(Δ), which turns the fp32
    rounding of a near-zero pseudo-gradient into a step of lr): the loss of
    each round and the params after both, at the tolerance of
    ``test_torch_train.py::test_fedsgd_step_matches_jax``."""
    kw = dict(param_dtype="float32", dtype="float32", remat=False)
    jcfg = jget_arch("smollm-360m").model.reduced(**kw)
    tcfg = get_arch("smollm-360m").model.reduced(**kw)
    jp = jT.init_params(jax.random.key(7), jcfg)
    tp = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    jopt, topt = joptim.adam(1e-2, eps=1e-3), toptim.adam(1e-2, eps=1e-3)
    jstep = jax.jit(jrounds.build_server_opt_round(
        lambda p, b: jT.lm_loss(jcfg, p, b[0]), 0.1, 2, jopt))
    tstep = trounds.build_server_opt_round(lambda p, b: tT.lm_loss(tcfg, p, b[0]), 0.1, 2, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(8)
    w = np.asarray([3.0, 1.0], np.float32)
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, size=(2, 2, 4, 9)).astype(np.int32)
        jp, js, jl = jstep(jp, js, (jnp.asarray(toks),), jnp.asarray(w))
        tp, ts, tl = tstep(tp, ts, (torch.from_numpy(toks),), torch.from_numpy(w))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    want = tT.params_from_jax(_np(jp), tcfg, device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def _quadratic(p, batch):
    return torch.sum((p["w"] - batch[0]) ** 2)


def test_server_opt_round_with_sgd1_is_plain_fedavg():
    plain = trounds.build_client_parallel_round(_quadratic, 0.1, 2)
    sopt = toptim.sgd(1.0)
    fedopt = trounds.build_server_opt_round(_quadratic, 0.1, 2, sopt)
    params = {"w": torch.zeros(2)}
    batches = (torch.tensor([[[1.0, -1.0]] * 2, [[2.0, 0.5]] * 2]),)  # (2 clients, 2 steps, 2)
    w = torch.ones(2)
    out_plain, _ = plain(params, batches, w)
    out_fedopt, _, _ = fedopt(params, sopt.init(params), batches, w)
    np.testing.assert_allclose(out_plain["w"].numpy(), out_fedopt["w"].numpy(), rtol=1e-6)


def test_server_momentum_accelerates_on_quadratic():
    batches = (torch.full((1, 1, 1), 4.0),)
    w = torch.ones(1)
    plain = trounds.build_client_parallel_round(_quadratic, 0.05, 1)
    sopt = toptim.sgd(1.0, momentum=0.6)
    fedopt = trounds.build_server_opt_round(_quadratic, 0.05, 1, sopt)
    p1, p2 = {"w": torch.zeros(1)}, {"w": torch.zeros(1)}
    st = sopt.init(p2)
    for _ in range(20):
        p1, _ = plain(p1, batches, w)
        p2, st, _ = fedopt(p2, st, batches, w)
    assert abs(float(p2["w"][0]) - 4.0) < abs(float(p1["w"][0]) - 4.0)


def test_records_add_cublas_workspaces_a_thread():
    """A record's peak is its arguments, the step's live peak and cuBLAS's
    workspaces: two for a step that takes gradients (the caller's thread
    and autograd's), one for a serving step."""
    from repro_torch.analysis.roofline import HW

    for shape, threads in (("train_4k", 2), ("decode_32k", 1)):
        rec = D.run_case(D.DryRunCase("smollm-360m", shape, reduced=True))
        assert rec["ok"], rec.get("error")
        assert rec["workspace_bytes"] == threads * HW.CUBLAS_WORKSPACE == threads * 32 * 2**20
        assert rec["peak_bytes"] == rec["argument_bytes"] + rec["step_peak"] + rec["workspace_bytes"]
