"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's: the analytic counts equal JAX's for every arch, shape and
mode, JAX's ``tests/test_analysis.py`` properties hold on one H100, and
the op histogram reads a record back.  The HLO parser's two tests have no
counterpart: the port has no HLO, and its collectives wait for ROADMAP
Queue 1 item 15."""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402

from repro_torch.analysis import ops as tops  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODES = ("client_parallel", "fedsgd_fsdp", "serve")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_param_count_equals_jax(arch):
    for jcfg, tcfg in ((jget_arch(arch).model, get_arch(arch).model),
                       (jget_arch(arch).long_context_model(), get_arch(arch).long_context_model())):
        for total in (False, True):
            assert troof.active_param_count(tcfg, total) == jroof.active_param_count(jcfg, total)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_wkv_correction_equal_jax(arch):
    """Every shape × mode × local steps, and the WKV count per card."""
    for shape in INPUT_SHAPES:
        for mode in MODES:
            for steps in (1, 2, get_arch(arch).fl.local_steps):
                assert troof.model_flops(arch, shape, mode, steps) == jroof.model_flops(arch, shape, mode, steps)
                for chips in (1, 256):
                    assert troof._wkv_flops_correction(arch, shape, chips, mode, steps) == (
                        jroof._wkv_flops_correction(arch, shape, chips, mode, steps))


def test_wkv_kernel_count_is_the_correction_per_token():
    """K7's fake-call count (``wkv6_flops``) is JAX's law per token and layer."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv6_flops

    cfg = get_arch("rwkv6-7b").model
    heads = cfg.d_model // cfg.rwkv_head_dim
    per_step = wkv6_flops(128, 1, heads, cfg.rwkv_head_dim) * cfg.num_layers
    assert per_step == troof._wkv_flops_correction("rwkv6-7b", "decode_32k", 1, "serve", 1)


def test_active_params_moe_smaller_than_total():
    cfg = get_arch("mixtral-8x7b").model
    act, tot = troof.active_param_count(cfg), troof.active_param_count(cfg, total=True)
    assert act < tot
    assert 0.2 < act / tot < 0.4  # ~13 B active of ~47 B (non-embedding)


def test_llama4_active_params_about_17b():
    cfg = get_arch("llama4-maverick-400b-a17b").model
    act, tot = troof.active_param_count(cfg), troof.active_param_count(cfg, total=True)
    assert 350e9 < tot < 450e9, tot
    assert 10e9 < act < 25e9, act


def test_model_flops_monotonic_in_shape():
    f_train = troof.model_flops("granite-3-2b", "train_4k", "client_parallel", 4)
    f_prefill = troof.model_flops("granite-3-2b", "prefill_32k", "serve")
    f_decode = troof.model_flops("granite-3-2b", "decode_32k", "serve")
    assert f_train > f_prefill > f_decode > 0


def _record(**kw):
    rec = dict(ok=True, case="arch", reduced=False, arch="granite-3-2b", shape="decode_32k", fl_mode="serve",
               dtype="bfloat16", flops=1e9, bytes_moved=5e9, peak_bytes=100 * 2**30, scan_rounds=1)
    rec.update(kw)
    return rec


def test_analyse_terms_and_dominant_on_one_h100():
    (r,) = troof.analyse([_record()])
    np.testing.assert_allclose(r["t_compute"], 1e9 / 989e12)
    np.testing.assert_allclose(r["t_memory"], 5e9 / 3.35e12)
    assert r["t_collective"] == 0.0  # one card: no collective
    assert r["dominant"] == "memory"
    assert r["useful_ratio"] > 0
    assert r["card"] == "NVIDIA H100 80GB HBM3"
    assert not r["fits_one_card"] and r["cards_needed"] == 2
    (c,) = troof.analyse([_record(flops=1e15, dtype="float32")])
    assert c["dominant"] == "compute"
    np.testing.assert_allclose(c["t_compute"], 1e15 / 67e12)  # fp32 on the CUDA cores, TF32 off


def test_analyse_skips_failed_reduced_and_engine_records():
    recs = [_record(ok=False), _record(reduced=True), dict(ok=True, case="serve_engine", arch="smollm-360m")]
    assert troof.analyse(recs) == []


def test_hw_constants_are_the_data_sheet_and_chip_smoke_uses_them():
    assert troof.HW.PEAK_FLOPS == {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
    assert troof.HW.HBM_BW == 3.35e12 and troof.HW.HBM_BYTES == 80 * 2**30
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PEAK_FLOPS is troof.HW.PEAK_FLOPS and smoke.PEAK_BYTES_PER_S == troof.HW.HBM_BW


def test_render_markdown_and_cli(tmp_path):
    inp = tmp_path / "dryrun.jsonl"
    recs = [_record(), _record(arch="smollm-360m", shape="train_4k", fl_mode="client_parallel",
                                flops=4e16, bytes_moved=3e12, peak_bytes=20 * 2**30)]
    inp.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out = tmp_path / "roofline.md"
    troof.main(["--inp", str(inp), "--out", str(out)])
    md = out.read_text()
    assert "NVIDIA H100 80GB HBM3" in md
    assert "| smollm-360m | train_4k | client_parallel |" in md and "**compute**" in md
    assert "| granite-3-2b | decode_32k | serve |" in md and "**memory**" in md
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert [r["arch"] for r in rows] == ["granite-3-2b", "smollm-360m"]
    mf = troof.model_flops("smollm-360m", "train_4k", "client_parallel", 8)
    assert math.isclose(rows[1]["useful_ratio"], mf / 4e16)


def test_op_histogram_reads_a_record_most_frequent_first():
    rec = {"ops": {"aten.mm": 3, "aten.add": 7, "aten.mul": 3}}
    assert tops.op_histogram(rec) == [("aten.add", 7), ("aten.mm", 3), ("aten.mul", 3)]
    assert tops.op_histogram(rec, top=1) == [("aten.add", 7)]


def test_step_counter_counts_ops_flops_bytes_and_live_memory():
    """On real tensors: a matmul's FLOPs by FlopCounterMode's formula, the
    bytes each op reads and writes, views free, and the peak of live
    storages made while counting (freed ones dropped)."""
    from torch.utils.flop_counter import FlopCounterMode

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    counter, fc = tops.StepCounter(), FlopCounterMode(display=False)
    counter.hold((a, b))
    with fc, counter:
        c = a @ b  # 2·8·16·4 FLOPs, reads 8·16 + 16·4 floats, writes 8·4
        t = c.t()  # a view: no bytes, no new storage
        d = (c * 2).sum()
        del c, t
        e = torch.ones(10)
    assert counter.ops == {"aten.mm": 1, "aten.t": 1, "aten.mul": 1, "aten.sum": 1, "aten.ones": 1}
    assert counter.flops == fc.get_total_flops() == 2 * 8 * 16 * 4
    assert counter.bytes_moved == 4 * ((128 + 64 + 32) + (32 + 32) + (32 + 1) + 10)
    assert counter.peak == 4 * (32 + 32 + 1) and counter.live == 4 * (1 + 10)
    del d, e


@pytest.mark.parametrize("contiguous", [True, False])
def test_step_counter_counts_softmax_backward_buffers_at_its_peak(contiguous):
    """``_softmax_backward_data`` holds, on the card, one buffer of its
    grad's bytes (grad × probabilities) and a second where the grad is not
    contiguous: the counter's peak at that op is its live bytes, its result
    and those buffers; no other op is charged any."""
    op = torch.ops.aten._softmax_backward_data.default
    probs = torch.softmax(torch.randn(2, 3, 4, 8), -1)
    grad = torch.randn(2, 3, 4, 8) if contiguous else torch.randn(2, 4, 3, 8).transpose(1, 2)
    want = grad.numel() * 4 * (1 if contiguous else 2)
    assert tops.card_temporaries(op, (grad, probs, -1, torch.float32)) == want
    assert tops.card_temporaries(torch.ops.aten.mm.default, (grad.reshape(-1, 8), torch.ones(8, 2))) == 0
    counter = tops.StepCounter()
    counter.hold((grad, probs))
    with counter:
        res = op(grad, probs, -1, torch.float32)
    assert counter.live == res.numel() * 4 and counter.peak == counter.live + want
