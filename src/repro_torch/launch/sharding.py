"""Logical-axis sharding: spec trees for parameters, caches and optimizer
state, and activation constraints, on ``torch.distributed`` DTensors.

The JAX package's names and rules (MaxText-style logical axes):

* ``param_logical_specs(cfg)`` mirrors the port's parameter tree
  (``transformer.init_params``: ``embed``, ``final_norm``, ``lm_head``
  and a per-layer ``blocks`` list) with an :class:`Ax` leaf, the logical
  axis names of each tensor's dims.  A block's entry is JAX's spec of the
  same leaf in its layer-stacked ``unit``/``rem`` tree with the stacked
  axis dropped (``transformer.params_from_jax`` pairs the leaves);
* ``rules`` (per arch and mode, ``configs.registry``) map each logical
  name to a mesh axis (``"data"``, ``"model"``) or ``None`` (replicated);
  on the multi-pod mesh every ``"data"`` widens to ``("pod", "data")``
  (:func:`resolve_axis`);
* ``specs_from_logical`` turns them into specs: a :class:`Spec` is a tuple
  with one entry per dim, a mesh-axis name, a tuple of names, or ``None``,
  as JAX's ``PartitionSpec``; :func:`placements` lays one on a
  ``DeviceMesh`` as DTensor placements, and :func:`distribute` a tree of
  tensors as DTensors holding this rank's shards;
* activation constraints are installed with :func:`use_rules`; the model
  code calls :func:`constrain`, which outside a rules context returns its
  argument and dispatches nothing, so the single-device paths never see
  the machinery.

A spec entry naming an axis the tensor's mesh lacks is left out of its
placements: inside a client body (``launch/dryrun.py``, Mode A) the
tensors live on the ``model`` axis alone, the client axis having taken
``data``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map as _local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_unflatten

__all__ = [
    "Ax",
    "ax",
    "Spec",
    "use_rules",
    "constrain",
    "resolve_axis",
    "param_logical_specs",
    "cache_logical_specs",
    "specs_from_logical",
    "optimizer_state_specs",
    "placements",
    "distribute",
    "map_specs",
    "spec_leaves",
    "is_dtensor",
    "contiguous_stride",
    "from_local_like",
    "local_offset",
    "local_map",
    "matmul",
    "replicate_dims",
    "reshape",
    "lay_out",
    "shard_like",
    "split_last",
    "sharded",
    "shards_dim",
    "CLIENT_AXIS",
    "client_axis_spec",
]

# Name of the federation's client axis (the client mesh's one axis,
# ``launch/mesh.make_client_mesh``)
CLIENT_AXIS = "clients"


class Spec(tuple):
    """A tensor's sharding: one entry per dim, a mesh-axis name, a tuple of
    names (major first) or ``None``; a leaf of the spec trees."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def client_axis_spec(ndim: int, axis: str = CLIENT_AXIS, batch_dims: int = 0) -> Spec:
    """The spec sharding dim ``batch_dims`` of a rank-``ndim`` per-client
    tensor over the client axis (leading batch dims stay replicated)."""
    return Spec((None,) * batch_dims + (axis,) + (None,) * (ndim - batch_dims - 1))


class Ax(tuple):
    """Marker leaf: the logical axis names of one tensor's dims."""


def ax(*names: Optional[str]) -> Ax:
    return Ax(names)


def _is_leaf(x) -> bool:
    return isinstance(x, (Ax, Spec))


def map_specs(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the :class:`Ax` or :class:`Spec` leaves of ``tree`` (and
    the same places of ``rest``, trees of tensors or specs), walked by
    ``tree``'s keys; other tuples are containers, as in ``repro_torch.tree``."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: map_specs(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [map_specs(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    raise TypeError(f"spec tree leaf {tree!r} is neither an Ax nor a Spec")


def spec_leaves(tree: Any) -> list:
    out: list = []
    map_specs(out.append, tree)
    return out


# the active rules: a process-wide stack, not a context variable, so that
# autograd's threads for the card (which run a checkpointed block's
# recompute) see the rules its forward saw
_ACTIVE_RULES: list = []


def resolve_axis(axis, multi_pod: bool):
    """'data' widens to ('pod', 'data') on the multi-pod mesh."""
    if axis == "data" and multi_pod:
        return ("pod", "data")
    return axis


def _resolve_rules(rules: Dict, multi_pod: bool) -> Dict:
    return {k: resolve_axis(v, multi_pod) for k, v in rules.items()}


@contextlib.contextmanager
def use_rules(rules: Dict, multi_pod: bool = False):
    """Install the activation-constraint rules for the model code run
    inside the block."""
    _ACTIVE_RULES.append(_resolve_rules(rules, multi_pod))
    try:
        yield
    finally:
        _ACTIVE_RULES.pop()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def from_local_like(local: torch.Tensor, mesh, place: tuple, shape: Sequence[int]) -> torch.Tensor:
    """A DTensor of the contiguous global ``shape`` holding ``local`` as
    this rank's shard under ``place`` (no collective, no check: the last
    shards of a dim that does not divide are short)."""
    return DTensor.from_local(local, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def local_offset(x, dim: int) -> int:
    """The global index of the first element of this rank's shard of the
    DTensor ``x`` along ``dim``, however many mesh axes cut it: each axis,
    in mesh order, cuts what the ones before left into chunks of the
    ceiling's size (DTensor's split, as :func:`_local_part`)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    size, off = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            off, size = off + start, min(chunk, size - start)
    return off


def local_map(func: Callable, out_placements, in_placements: tuple, device_mesh) -> Callable:
    """``torch.distributed.tensor.experimental.local_map`` with each
    input's gradient laid out as autograd must sum it: on a mesh axis on
    which the input is replicated while another input is cut, each device
    holds its part of the input's gradient (pending sums, as a replicated
    table's rows read by each device's tokens); the gradient of an input
    holding pending sums is whole on every device (replicated).  Elsewhere
    the gradient is laid out as the input."""
    ins = [tuple(p) for p in in_placements]

    def grad(place):
        return tuple(
            Replicate() if p.is_partial()
            else Partial() if p.is_replicate() and any(o[i].is_shard() for o in ins)
            else p
            for i, p in enumerate(place)
        )

    return _local_map(func, out_placements=out_placements, in_placements=in_placements,
                      in_grad_placements=tuple(grad(p) for p in ins), device_mesh=device_mesh)


def placements(spec: Sequence, mesh) -> tuple:
    """``spec`` on ``mesh`` (a ``DeviceMesh`` with named dims) as DTensor
    placements: ``Shard(d)`` on each mesh dim that dim ``d`` names,
    ``Replicate()`` elsewhere.  Axes the mesh lacks are left out (module
    docstring); two dims on one axis raise."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name not in names:
                continue
            i = names.index(name)
            if out[i] != Replicate():
                raise ValueError(f"spec {tuple(spec)}: mesh axis {name!r} shards two dims")
            if mesh.size(i) > 1:  # an axis of one device cuts nothing: replicated
                out[i] = Shard(dim)
    return tuple(out)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Outside :func:`use_rules`: ``x`` itself, no op dispatched.  Inside:
    a DTensor ``x`` redistributed to the spec its dims' logical names map
    to (JAX's ``with_sharding_constraint``; a ``None`` dim is replicated);
    a plain tensor is returned as it is."""
    rules = _ACTIVE_RULES[-1] if _ACTIVE_RULES else None
    if rules is None or not is_dtensor(x):
        return x
    target = placements(tuple(rules.get(name) if name else None for name in logical), x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def _local_part(x: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """This rank's shard of the global tensor ``x`` under ``place``."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if p.is_shard():
            chunks = torch.chunk(x, mesh.size(i), dim=p.dim)
            x = chunks[coord[i]] if coord[i] < len(chunks) else x.narrow(p.dim, 0, 0)
    return x.clone() if any(p.is_shard() for p in place) else x


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, out = 1, []
    for n in reversed(tuple(shape)):
        out.append(stride)
        stride *= max(n, 1)
    return tuple(reversed(out))


def shards_dim(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor with dim ``dim`` sharded on a mesh axis
    of more than one device."""
    return is_dtensor(x) and any(p.is_shard(dim) and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements))


def sharded(x) -> bool:
    """Whether ``x`` is a DTensor cut (or holding pending sums) over a mesh
    axis of more than one device.  The sharded paths of the model code key
    on this: a DTensor replicated everywhere (a (1, 1) mesh) takes the
    plain code, so its counts are one card's."""
    return is_dtensor(x) and any(
        (p.is_shard() or p.is_partial()) and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements)
    )


def replicate_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A DTensor ``x`` with the mesh axes that shard any of ``dims`` (or
    hold pending sums) made replicated; anything else as it is."""
    if not is_dtensor(x):
        return x
    target = tuple(Replicate() if p.is_partial() or any(p.is_shard(d) for d in dims) else p for p in x.placements)
    return x if target == tuple(x.placements) else x.redistribute(x.device_mesh, target)


def _reshape_layout(x, shape: Tuple[int, ...]):
    """``x`` laid out so that DTensor can reshape it to ``shape``: a mesh
    axis sharding a dim the reshape changes is kept only where the dim is
    split and its first part divides over the shards (64 heads over 16
    devices), or where it is the first of the dims merged and divides over
    them; elsewhere (4 heads over 16 devices, a sequence merged into the
    batch) it is replicated first."""
    src = tuple(x.shape)
    i = 0
    while i < min(len(src), len(shape)) and src[i] == shape[i]:
        i += 1
    j = 0
    while j < min(len(src), len(shape)) - i and src[-1 - j] == shape[-1 - j]:
        j += 1
    block_in, block_out = range(i, len(src) - j), range(i, len(shape) - j)
    mesh = x.device_mesh

    def ok(d: int) -> bool:
        if d not in block_in:
            return True
        n = math.prod(mesh.size(k) for k, p in enumerate(x.placements) if p.is_shard(d))
        if len(block_in) == 1:  # a split
            return len(block_out) > 0 and shape[block_out[0]] % n == 0
        return len(block_out) == 1 and d == block_in[0] and src[d] % n == 0  # a merge

    target = tuple(p if not p.is_shard() or ok(p.dim) else Replicate() for p in x.placements)
    return x if target == tuple(x.placements) else x.redistribute(mesh, target)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose forward and backward both lay their input out
    by :func:`_reshape_layout` first; ``unsafe`` takes ``_unsafe_view`` for
    the forward, as ``matmul`` unflattens its product."""

    @staticmethod
    def forward(ctx, x, shape, unsafe=False):
        ctx.src = tuple(x.shape)
        x = _reshape_layout(x, shape)
        return torch.ops.aten._unsafe_view(x, shape) if unsafe else x.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape_layout(grad, ctx.src).reshape(ctx.src), None, None


def reshape(x: torch.Tensor, *shape: int, unsafe: bool = False) -> torch.Tensor:
    """``x.reshape(*shape)``; a DTensor is first laid out so DTensor can
    reshape it, forward and backward (:func:`_reshape_layout`: its gradient
    may come back sharded where it was not)."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    n = math.prod(x.shape)
    known = math.prod(d for d in shape if d != -1)
    full = tuple(n // known if d == -1 else d for d in shape)
    return _Reshape.apply(x, full, unsafe)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``.  On a DTensor ``x`` of more than two dims
    the rows are flattened and unflattened by :func:`reshape`, forward and
    backward, around a 2-D product: DTensor's own flatten inside ``matmul``
    can leave a sequence sharded within the rows, a layout its ``mm``
    cannot take.  A product over a sharded inner dim (pending sums) is
    reduce-scattered over its output's columns.  Plain tensors: the
    product alone."""
    if not is_dtensor(x):
        return x @ w
    if x.ndim <= 2:
        return _columns(x @ w)
    lead = tuple(x.shape[:-1])
    rows = reshape(replicate_dims(x, *range(1, x.ndim - 1)), -1, x.shape[-1])
    return reshape(_columns(rows @ w), *lead, w.shape[-1], unsafe=True)  # matmul's own ops: view, mm, _unsafe_view


def _columns(y):
    """A 2-D DTensor product's pending sums made its columns' shards."""
    if not any(p.is_partial() for p in y.placements):
        return y
    return y.redistribute(y.device_mesh, tuple(Shard(1) if p.is_partial() else p for p in y.placements))


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` with its last dim split into ``sizes`` (heads and their width),
    through :func:`reshape`; on plain tensors the reshape alone."""
    return reshape(x, *x.shape[:-1], *sizes)


def lay_out(x: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh`` with placements ``place``: a DTensor
    redistributed, a plain tensor (global) cut to this rank's shard."""
    if is_dtensor(x):
        return x.redistribute(mesh, place)
    return from_local_like(_local_part(x, mesh, place), mesh, place, x.shape)


def shard_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x``, a plain tensor whose leading dims are ``ref``'s, laid out as
    the sharded DTensor ``ref`` (its shards of those dims; replicated
    elsewhere) by :func:`lay_out`.  Anything else is returned as it is: on
    plain tensors this dispatches nothing."""
    if not sharded(ref) or is_dtensor(x):
        return x
    place = tuple(p if p.is_shard() and p.dim < x.ndim else Replicate() for p in ref.placements)
    return lay_out(x, ref.device_mesh, place)


def distribute(tree: Any, specs: Any, mesh, requires_grad: Optional[bool] = None) -> Any:
    """Tensors of ``tree`` (global shapes) -> DTensors on ``mesh`` laid out
    by ``specs`` (a spec tree over the same structure), each holding this
    rank's shard as a fresh tensor.  No collective: every rank cuts its own
    shard.  ``requires_grad`` sets it on the DTensors (as leaves)."""
    def one(spec: Spec, x: torch.Tensor):
        place = placements(spec, mesh)
        local = _local_part(x.detach(), mesh, place)
        out = from_local_like(local, mesh, place, x.shape)
        if requires_grad is not None:
            out.requires_grad_(requires_grad)
        return out

    return map_specs(one, specs, tree)


# --------------------------------------------------------------- param specs


def _attn_specs() -> Dict:
    return {
        "wq": {"w": ax("attn_in_w", "heads_w")},
        "wk": {"w": ax("attn_in_w", "kv_w")},
        "wv": {"w": ax("attn_in_w", "kv_w")},
        "wo": {"w": ax("heads_w", "attn_out_w")},
    }


def _mlp_specs(cfg: ModelConfig) -> Dict:
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "wi": {"w": ax("embed_w", "mlp_w")},
            "wg": {"w": ax("embed_w", "mlp_w")},
            "wo": {"w": ax("mlp_w", "embed_w")},
        }
    return {"wi": {"w": ax("embed_w", "mlp_w")}, "wo": {"w": ax("mlp_w", "embed_w")}}


def _moe_specs(cfg: ModelConfig) -> Dict:
    s = {
        "router": {"w": ax("embed_w", None)},
        "wi": ax("experts_w", "expert_embed_w", "expert_mlp_w"),
        "wg": ax("experts_w", "expert_embed_w", "expert_mlp_w"),
        "wo": ax("experts_w", "expert_mlp_w", "expert_embed_w"),
    }
    if cfg.shared_expert:
        s["shared"] = _mlp_specs(cfg)
    return s


def _rglru_specs() -> Dict:
    return {
        "w_in": {"w": ax("embed_w", "rnn_w")},
        "w_gate": {"w": ax("embed_w", "rnn_w")},
        "w_out": {"w": ax("rnn_w", "embed_w")},
        "conv_w": ax(None, "rnn_w"),
        "conv_b": ax("rnn_w"),
        "w_r": {"w": ax(None, "rnn_w")},
        "b_r": ax("rnn_w"),
        "w_i": {"w": ax(None, "rnn_w")},
        "b_i": ax("rnn_w"),
        "lam": ax("rnn_w"),
    }


def _rwkv_tmix_specs() -> Dict:
    vec = ax("embed_w_vec")
    return {
        "mu_x": vec, "mu_w": vec, "mu_k": vec, "mu_v": vec, "mu_r": vec, "mu_g": vec,
        # the decay path and the per-head norm live in the attention (H·hd)
        # dim: "att_vec_w" lets a variant co-shard them with att_w
        "w0": ax("att_vec_w"),
        "a_w": ax("embed_w", None),
        "b_w": ax(None, "att_vec_w"),
        "u": ax(None, None),
        "wr": {"w": ax("embed_w", "att_w")},
        "wk": {"w": ax("embed_w", "att_w")},
        "wv": {"w": ax("embed_w", "att_w")},
        "wg": {"w": ax("embed_w", "att_w")},
        "wo": {"w": ax("att_w", "embed_w")},
        "ln_scale": ax("att_vec_w"),
    }


def _rwkv_cmix_specs() -> Dict:
    return {
        "mu_k": ax("embed_w_vec"),
        "mu_r": ax("embed_w_vec"),
        "wk": {"w": ax("embed_w", "mlp_w")},
        "wv": {"w": ax("mlp_w", "embed_w")},
        "wr": {"w": ax("embed_w", "att_w")},
    }


def _norm_specs(cfg: ModelConfig) -> Dict:
    s = {"scale": ax("embed_w_vec")}
    if cfg.norm_type == "layernorm":
        s["bias"] = ax("embed_w_vec")
    return s


def _block_specs(cfg: ModelConfig, btype: str) -> Dict:
    mixer, ffn = btype.split("+")
    out = {"norm1": _norm_specs(cfg), "norm2": _norm_specs(cfg)}
    out["mixer"] = (
        _attn_specs()
        if mixer in ("attn", "swa", "local")
        else _rglru_specs() if mixer == "rglru" else _rwkv_tmix_specs()
    )
    out["ffn"] = _mlp_specs(cfg) if ffn == "mlp" else _moe_specs(cfg) if ffn == "moe" else _rwkv_cmix_specs()
    return out


def _prepend(tree, axis):
    return map_specs(lambda t: Ax((axis,) + tuple(t)), tree)


def param_logical_specs(cfg: ModelConfig) -> Dict:
    """The logical axes of every leaf of ``transformer.init_params(cfg)``,
    in its structure (one block entry per layer)."""
    specs: Dict = {"embed": {"w": ax("vocab_w", "embed_w")}, "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ax("embed_w", "vocab_w")}
    specs["blocks"] = [_block_specs(cfg, b) for b in cfg.layer_types()]
    return specs


def cache_logical_specs(cfg: ModelConfig) -> Dict:
    """The logical axes of ``transformer.init_caches``' leaves: the caches
    keep JAX's layer-stacked layout, so these are JAX's specs."""

    def block_cache(btype: str, stacked: bool):
        mixer, _ = btype.split("+")
        if mixer in ("attn", "swa", "local"):
            c = {
                "k": ax("act_batch", "cache_seq", None, None),
                "v": ax("act_batch", "cache_seq", None, None),
                "pos": ax(),
            }
        elif mixer == "rglru":
            c = {"conv": ax("act_batch", None, "rnn_w"), "h": ax("act_batch", "rnn_w"), "pos": ax()}
        else:  # rwkv (time-mix and channel-mix states)
            c = {
                "tm_x": ax("act_batch", "embed_act"),
                "wkv": ax("act_batch", "rwkv_heads", None, None),
                "cm_x": ax("act_batch", "embed_act"),
                "pos": ax(),
            }
        return _prepend(c, None) if stacked else c

    pattern = cfg.block_pattern
    rem = cfg.num_layers % len(pattern)
    return {
        "unit": tuple(block_cache(b, True) for b in pattern),
        "rem": tuple(block_cache(pattern[j], False) for j in range(rem)),
    }


def specs_from_logical(logical_tree, rules: Dict, multi_pod: bool = False):
    """Logical :class:`Ax` leaves -> :class:`Spec` leaves under ``rules``."""
    rr = _resolve_rules(rules, multi_pod)
    return map_specs(lambda t: Spec(rr.get(name) if name else None for name in t), logical_tree)


def optimizer_state_specs(opt_name: str, param_specs, cfg: Optional[ModelConfig] = None):
    """The spec tree of the optimizer state ``launch/train.pretrain_optimizer``
    makes for params with ``param_specs``: sgd holds none; adam's moments
    are laid out as the params; adafactor (``cfg`` given) holds one entry
    a group of ``transformer.layer_groups`` (a leaf alone, or a pattern
    entry's layers stacked, whose spec gains a replicated leading dim),
    its row moments dropping the last dim and its column moments the one
    before, as JAX's factored state."""
    from repro_torch.optim.optimizers import AdafactorState, AdamState

    if opt_name == "sgd":
        return ()
    if opt_name in ("adam", "adamw"):
        return AdamState(Spec(()), param_specs, param_specs)
    if opt_name == "adafactor":
        if cfg is None:
            raise ValueError("adafactor's state specs follow the layer groups: pass cfg")
        from repro_torch.models.transformer import layer_groups

        flat = spec_leaves(param_specs)
        index = tree_unflatten(map_specs(lambda _: 0, param_specs), range(len(flat)))
        stacked = [flat[g] if isinstance(g, int) else Spec((None,) + tuple(flat[g[0]])) for g in
                   layer_groups(cfg, index)]
        vr = [Spec(s[:-1]) if len(s) >= 2 else s for s in stacked]
        vc = [Spec(tuple(s[:-2]) + (s[-1],)) if len(s) >= 2 else Spec(()) for s in stacked]
        return AdafactorState(Spec(()), vr, vc)
    raise ValueError(opt_name)

