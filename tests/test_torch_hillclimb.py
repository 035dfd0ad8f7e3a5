"""The port's hillclimb (``repro_torch.analysis.hillclimb``)
against the JAX package's ``repro.analysis.hillclimb``: the same variants
(names and overrides, in order) for every pair, and the same ``PAIRS``.
JAX's module forces 512 host devices when imported, so its table is read
in a subprocess.  One pair's variants are evaluated on reduced configs
through the port's sharded dry run."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import hillclimb as H  # noqa: E402
from repro_torch.configs import ARCH_NAMES  # noqa: E402
from repro_torch.launch.mesh import release_fake_meshes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(autouse=True, scope="module")
def own_fake_group():
    """The fake meshes' default group lives only while this file runs: other
    files in the same worker hold process groups of their own."""
    yield
    release_fake_meshes()


def test_variant_table_and_pairs_equal_jax():
    code = (
        "import json, sys\n"
        "from repro.analysis import hillclimb as H\n"
        f"archs, shapes = {list(ARCH_NAMES)!r}, {list(SHAPES)!r}\n"
        "print(json.dumps({'pairs': H.PAIRS, 'variants': {a + ':' + s: H._variants(a, s)"
        " for a in archs for s in shapes}}))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True, capture_output=True,
                         text=True, timeout=300).stdout
    jax = json.loads(out.strip().splitlines()[-1])
    assert [list(p) for p in H.PAIRS] == jax["pairs"]
    port = {f"{a}:{s}": H._variants(a, s) for a in ARCH_NAMES for s in SHAPES}
    assert json.loads(json.dumps(port)) == jax["variants"]


def test_run_pair_on_reduced_configs(tmp_path):
    """mixtral-8x7b's prefill pair on reduced configs: every variant ``ok``
    on the 16 x 16 mesh with the three terms, appended in order to the
    file given; v1 moves the experts' second shard axis, so its
    collectives differ from the baseline's."""
    out = tmp_path / "hc.jsonl"
    rows = H.run_pair("mixtral-8x7b", "prefill_32k", str(out), reduced=True)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["variant"] for r in recs] == [v[0] for v in H._variants("mixtral-8x7b", "prefill_32k")]
    assert all(r["ok"] and r["t_collective"] > 0 and r["t_memory"] > 0 and r["mesh"] == "16x16" for r in recs)
    assert recs[1]["collectives"] != recs[0]["collectives"] and recs[0]["useful_ratio"] is None
    assert rows[0]["devices"] == 256 and H.OUT == "results/hillclimb_torch.jsonl"
