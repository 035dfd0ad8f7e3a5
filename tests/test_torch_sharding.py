"""The port's model axis (``repro_torch.launch.sharding``, the rules in
``repro_torch.configs``, ``launch/mesh.make_production_mesh``) against the
JAX package's ``repro.launch.sharding`` on the CPU.

Every leaf of the port's parameter tree (a per-layer ``blocks`` list) has
JAX's spec of its counterpart in JAX's layer-stacked tree with the stacked
axis dropped, for all ten archs, both rule sets and both meshes; the
caches' and the optimizers' specs are JAX's; and at full width each
leaf's shard on rank 0 of the production mesh equals JAX's
``NamedSharding(AbstractMesh(...), spec).shard_shape`` (or, where a dim
does not divide its axes, JAX's padded shard, the ceiling).  Nothing is
compiled: specs and shapes only (``jax.eval_shape``, fake tensors).  The
MoE router's aux loss is held bit for bit to its old one-hot spelling and
to JAX's; the single-device dry run's op histograms to the previous
commit's (recorded below)."""

import hashlib
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jT  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.configs.registry import SERVE_RULES, TRAIN_RULES  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, release_fake_meshes  # noqa: E402
from repro_torch.launch.train import pretrain_optimizer  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def own_fake_group():
    """The fake meshes' default group lives only while this file runs: other
    files in the same worker hold process groups of their own."""
    yield
    release_fake_meshes()


def _jax_paths(tree):
    """{path: leaf} of a JAX spec tree, paths of dict keys and sequence
    indices (P leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, leaf in flat:
        out[tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)] = leaf
    return out


def _port_paths(tree, prefix=()):
    """[(path, leaf)] of a port tree of Spec leaves (or tensors), in the
    port's own order; a block's path is its JAX counterpart's: ('unit', j,
    ...) with the layer's unit index apart, or ('rem', j, ...)."""
    if isinstance(tree, (sh.Spec, torch.Tensor)):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _port_paths(v, prefix + (k,))]
    return [pl for i, v in enumerate(tree) for pl in _port_paths(v, prefix + (i,))]


def _block_path(cfg, path):
    """A port path under 'blocks' -> (JAX path, stacked)."""
    if path[0] != "blocks":
        return path, False
    n = len(cfg.block_pattern)
    reps = cfg.num_layers // n
    layer = path[1]
    if layer < reps * n:
        return ("unit", layer % n) + path[2:], True
    return ("rem", layer - reps * n) + path[2:], False


def test_rules_equal_jax():
    assert SERVE_RULES == __import__("repro.configs.registry", fromlist=["x"]).SERVE_RULES
    assert TRAIN_RULES == __import__("repro.configs.registry", fromlist=["x"]).TRAIN_RULES
    for arch in ARCH_NAMES:
        p, j = get_arch(arch), jget_arch(arch)
        assert (p.train_rules, p.serve_rules) == (j.train_rules, j.serve_rules), arch


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_specs_equal_jax(arch):
    """Both rule sets, both meshes, the long-context form too: each port
    leaf's spec is JAX's with the stacked axis dropped; the caches'
    (stacked in both) are JAX's."""
    spec = get_arch(arch)
    for cfg in {spec.model, spec.long_context_model()}:
        for rules in (spec.train_rules, spec.serve_rules):
            for mp in (False, True):
                jp = _jax_paths(jsh.specs_from_logical(jsh.param_logical_specs(cfg), rules, mp))
                port = _port_paths(sh.specs_from_logical(sh.param_logical_specs(cfg), rules, mp))
                seen = set()
                for path, s in port:
                    jpath, stacked = _block_path(cfg, path)
                    want = tuple(jp[jpath])[1:] if stacked else tuple(jp[jpath])
                    assert tuple(s) == want, (arch, rules is spec.train_rules, mp, path)
                    seen.add(jpath)
                assert seen == set(jp)
                jc = _jax_paths(jsh.specs_from_logical(jsh.cache_logical_specs(cfg), rules, mp))
                pc = dict(_port_paths(sh.specs_from_logical(sh.cache_logical_specs(cfg), rules, mp)))
                assert {k: tuple(v) for k, v in pc.items()} == {k: tuple(v) for k, v in jc.items()}


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "mixtral-8x7b", "smollm-360m"])
def test_optimizer_state_specs_equal_jax(arch):
    """Adam's moments are laid out as the params; Adafactor's factored
    moments, one entry a layer group (``transformer.layer_groups``), are
    JAX's of the same stacked leaf; the state's structure is the port
    optimizer's own."""
    spec = get_arch(arch)
    cfg = spec.model.reduced()
    rules = spec.train_rules
    pspecs = sh.specs_from_logical(sh.param_logical_specs(cfg), rules, True)
    jspecs = jsh.specs_from_logical(jsh.param_logical_specs(cfg), rules, True)
    params = tT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for name in ("adam", "adafactor"):
        state = pretrain_optimizer(cfg, name, 1e-3).init(params)
        specs = sh.optimizer_state_specs(name, pspecs, cfg)
        assert [tuple(x.shape) for x in tree_leaves(state)] and len(sh.spec_leaves(specs)) == len(tree_leaves(state))
        for s, x in zip(sh.spec_leaves(specs), tree_leaves(state)):
            assert len(s) == x.ndim, (name, s, tuple(x.shape))
        if name == "adam":
            assert specs.mu is pspecs and specs.nu is pspecs
            continue
        jstate = jsh.optimizer_state_specs("adafactor", jspecs)
        jvr, jvc = _jax_paths(jstate.vr), _jax_paths(jstate.vc)
        groups = tT.layer_groups(cfg, params)
        paths = [p for p, _ in _port_paths(params)]
        for g, vr, vc in zip(groups, specs.vr, specs.vc):
            jpath = _block_path(cfg, paths[g if isinstance(g, int) else g[0]])[0]
            assert (tuple(vr), tuple(vc)) == (tuple(jvr[jpath]), tuple(jvc[jpath])), jpath


def _shard_dim(n: int, k: int) -> int:
    """JAX's shard of a dim of n over k devices, padded to the ceiling."""
    return -(-n // k)


def _jax_shard_shape(shape, spec, mesh_dims) -> tuple:
    mesh = AbstractMesh(*mesh_dims) if _abstract_takes_shape() else AbstractMesh(tuple(zip(mesh_dims[1],
                                                                                          mesh_dims[0])))
    try:
        return tuple(NamedSharding(mesh, spec).shard_shape(tuple(shape)))
    except ValueError:  # a dim that does not divide its axes: JAX pads it
        sizes = dict(zip(mesh_dims[1], mesh_dims[0]))
        out = []
        for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            out.append(_shard_dim(n, math.prod(sizes[a] for a in axes)))
        return tuple(out)


def _abstract_takes_shape() -> bool:
    try:
        AbstractMesh((1,), ("x",))
        return True
    except TypeError:
        return False


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_full_width_shards_equal_jax_shard_shape(arch):
    """Rank 0's shard of every parameter (train and serve rules) and of
    every cache leaf of decode_32k (batch 128 over the data axes), at full
    width (the depth cut to one repeat unit and the remainder layers) on
    both production meshes, laid out by ``sharding.distribute`` on fake
    tensors: JAX's shard shape of the same leaf of its ``eval_shape``
    tree, the stacked axis dropped."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = get_arch(arch)
    # every width the arch's, its depth one repeat unit and its remainder
    # layers (each unit's layers have the same leaves)
    n = len(spec.model.block_pattern)
    depth = n + spec.model.num_layers % n
    cfg = dataclasses.replace(spec.model, num_layers=depth)
    jcfg = dataclasses.replace(jget_arch(arch).model, num_layers=depth)
    jparams = _jax_paths(jax.eval_shape(lambda k: jT.init_params(k, jcfg), jax.random.key(0)))
    jcaches = _jax_paths(jax.eval_shape(lambda: jT.init_caches(jcfg, 128, 32_768)))
    for mp, dims in MESHES.items():
        mesh = make_production_mesh(multi_pod=mp)
        with FakeTensorMode():
            params = tT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
            caches = tT.init_caches(cfg, 128, 32_768, device="cpu")
            for rules in (spec.train_rules, spec.serve_rules):
                js = _jax_paths(jsh.specs_from_logical(jsh.param_logical_specs(jcfg), rules, mp))
                laid = sh.distribute(params, sh.specs_from_logical(sh.param_logical_specs(cfg), rules, mp), mesh)
                for path, x in _port_paths(laid):
                    jpath, stacked = _block_path(cfg, path)
                    jshape, jspec = jparams[jpath].shape, js[jpath]
                    if stacked:
                        jshape, jspec = jshape[1:], P(*tuple(jspec)[1:])
                    assert tuple(x.to_local().shape) == _jax_shard_shape(jshape, jspec, dims), (mp, path)
            cs = sh.specs_from_logical(sh.cache_logical_specs(cfg), spec.serve_rules, mp)
            jcs = _jax_paths(jsh.specs_from_logical(jsh.cache_logical_specs(jcfg), spec.serve_rules, mp))
            for path, x in _port_paths(sh.distribute(caches, cs, mesh)):
                assert tuple(x.to_local().shape) == _jax_shard_shape(jcaches[path].shape, jcs[path], dims), path


def test_placements_and_constrain():
    """A spec on the mesh: each named axis shards its dim, ('pod', 'data')
    both of one dim, an axis the mesh lacks is left out; two dims on one
    axis raise.  ``constrain`` outside ``use_rules`` returns its argument
    and dispatches nothing; inside it redistributes a DTensor (one
    all-gather over ``model`` here) and leaves a plain tensor as it is."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis.ops import StepCounter

    mesh = make_production_mesh(multi_pod=True)
    assert sh.placements(sh.Spec((("pod", "data"), "model")), mesh) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(sh.Spec(("clients", None)), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements(sh.Spec(("model", "model")), mesh)
    assert sh.resolve_axis("data", True) == ("pod", "data") and sh.resolve_axis("data", False) == "data"
    assert sh.client_axis_spec(3, batch_dims=1) == (None, "clients", None)
    mesh = make_production_mesh()
    x = sh.distribute(torch.arange(64.0).reshape(16, 4), sh.Spec(("data", "model")), mesh)
    counter = StepCounter(mesh)
    with counter:
        assert sh.constrain(x, "act_batch", "act_embed") is x
        plain = torch.ones(3)
        with sh.use_rules(SERVE_RULES):
            assert sh.constrain(plain, "act_batch") is plain
            y = sh.constrain(x, "act_batch", "act_embed")
    assert counter.ops["_c10d_functional.all_gather_into_tensor"] == 1
    assert tuple(y.placements) == (Shard(0), Replicate()) and tuple(y.to_local().shape) == (1, 4)


def test_moe_aux_loss_is_bit_identical_to_one_hot_and_jax():
    """The router's aux loss after the one-hot repair (a comparison with
    arange, no host read): the same fp32 bits as ``F.one_hot``'s spelling;
    the experts' fp32 counts equal JAX's one-hot's bit for bit, and the
    loss JAX's ``_route``'s within four fp32 steps (XLA rounds its mean and
    softmax its own way, as the MoE tests' bound allows)."""
    import torch.nn.functional as F

    for arch in ("mixtral-8x7b", "llama4-maverick-400b-a17b"):
        cfg = get_arch(arch).model.reduced()
        e, k = cfg.num_experts, cfg.experts_per_token
        for n in (96, 1000):
            logits = np.random.default_rng(n).normal(size=(n, e)).astype(np.float32)
            idx, _, aux = tmoe._route(cfg, torch.tensor(logits))
            frac = torch.mean(F.one_hot(idx, e).float().sum(dim=1), dim=0) / k
            probs = torch.mean(torch.softmax(torch.tensor(logits), dim=-1), dim=0)
            old = e * torch.sum(frac * probs) * cfg.router_aux_coef
            assert aux.dtype == torch.float32 and aux.numpy().tobytes() == old.numpy().tobytes(), (arch, n)
            jidx, _, jaux = jmoe._route(jget_arch(arch).model.reduced(), jnp.asarray(logits))
            counts = (idx[..., None] == torch.arange(e)).float().sum(dim=(0, 1))
            jcounts = jax.nn.one_hot(jidx, e, dtype=jnp.float32).sum(axis=(0, 1))
            assert np.array_equal(np.asarray(jidx), idx.numpy())
            assert np.asarray(jcounts).tobytes() == counts.numpy().tobytes()
            np.testing.assert_allclose(float(aux), float(jaux), rtol=4 * 2.0**-23, atol=0)


# the unsharded dry run's op histograms on the previous commit (sha256 of
# the sorted histogram's JSON, first 16 hex digits), and for the MoE case
# the whole histogram: the one-hot repair drops one aten._to_copy (the
# int64 one-hot's cast to fp32) from each router call, and nothing else
PARENT_HISTOGRAMS = {
    ("smollm-360m", "train_4k", 2): (78609, "665a49e2cbbaa13b"),
    ("rwkv6-7b", "decode_32k", None): (269, "f2e1b948e9be60a4"),
    ("recurrentgemma-9b", "decode_32k", None): (851, "190076b797e93435"),
    ("qwen2-vl-2b", "prefill_32k", None): (340, "dd0482793a16e9e5"),
}
PARENT_MIXTRAL_PREFILL = {
    "aten.arange": 15, "aten.unsqueeze": 41, "aten.expand": 5, "aten.index": 9, "aten.zeros": 11, "aten.select": 6,
    "aten._to_copy": 39, "aten.mul": 59, "aten.mean": 9, "aten.add": 21, "aten.rsqrt": 5, "aten.view": 42,
    "aten.mm": 10, "aten._unsafe_view": 19, "aten.div": 6, "aten.pow": 4, "aten.reciprocal": 6, "aten.slice": 15,
    "aten.cos": 4, "aten.sin": 4, "aten.sub": 14, "aten.cat": 4, "aten.remainder": 4, "aten.index_put_": 10,
    "aten.ge": 2, "aten.lt": 4, "aten.bitwise_and": 2, "aten.permute": 20, "aten.clone": 10, "aten.bmm": 11,
    "aten.le": 2, "aten.gt": 2, "aten.bitwise_and_": 4, "aten.scalar_tensor": 6, "aten.where": 6,
    "aten._softmax": 6, "aten.topk": 2, "aten.eq": 2, "aten.sum": 4, "aten.sort": 2, "aten.searchsorted": 2,
    "aten.floor_divide": 2, "aten.neg": 2, "aten.exp": 2, "aten.index_add": 2, "aten.stack": 1,
}


@pytest.mark.parametrize("key", list(PARENT_HISTOGRAMS) + [("mixtral-8x7b", "prefill_32k", None)])
def test_single_device_op_histograms_are_unchanged(key):
    """The constraint sites and the DTensor branches dispatch nothing on
    plain tensors: the one-card dry run's histograms are the previous
    commit's (the MoE router's by the repair's one op a call)."""
    arch, shape, clients = key
    kw = {} if clients is None else {"clients": clients}
    ops = D.count_step(D.DryRunCase(arch, shape, reduced=True, **kw))["ops"]
    if key in PARENT_HISTOGRAMS:
        digest = hashlib.sha256(json.dumps(sorted(ops.items())).encode()).hexdigest()[:16]
        assert (sum(ops.values()), digest) == PARENT_HISTOGRAMS[key], sorted(ops.items())
    else:
        want = dict(PARENT_MIXTRAL_PREFILL, **{"aten._to_copy": PARENT_MIXTRAL_PREFILL["aten._to_copy"] - 2})
        assert ops == want  # 2 MoE layers, one router call each
