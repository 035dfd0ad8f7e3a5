"""Dry run: one step of each (arch × input shape) at full width on fake
tensors, and what it would take on one H100, or on each H100 of a
production mesh, without running it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --reduced
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --out build/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape decode_32k --reduced --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-sharded --fl-devices 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-engine

The step is the port's own code path on tensors that have shapes and
dtypes but no storage (``torch._subclasses.fake_tensor.FakeTensorMode``):
a Mode-A round (``fl/rounds.build_client_parallel_round``: 16 clients,
the arch's ``local_steps`` and micro-batches), a Mode-B step
(``build_fedsgd_step`` with the arch's optimizer as the JAX package steps
it), a prefill or a decode step (through K5 and K7, as the serving path
takes them).  Each record holds:

* ``params``; ``argument_bytes`` (params, optimizer state, batch, client
  weights, caches) and ``output_bytes``;
* ``peak_bytes``: the arguments plus the most bytes the step holds live
  beside them (``analysis/ops.StepCounter``: each result's storage added
  when made, dropped when freed, and the buffers a kernel on the card
  allocates for itself, ``analysis/ops.card_temporaries``) plus cuBLAS's
  workspaces (``workspace_bytes``: one for each thread that runs a
  matmul), as a process that runs the step alone holds them;
* ``flops``: the step's matmul FLOPs by ``FlopCounterMode``'s formulas plus the
  model kernels' analytic FLOPs (``kernel_flops``: a kernel's wrapper on
  fake tensors launches nothing and records its count), and
  ``bytes_moved``, every op's argument and result bytes;
* ``ops``, the aten-op histogram (``analysis/ops.op_histogram``);
* ``fits_one_card`` and ``cards_needed`` on the card named in ``card``.

Counting a full-width step op by op on fake tensors would take hours (16
clients × E steps × micro-batches of passes through every layer), so the
counts are exact extrapolations: the repeat units of a config are
identical, so the step is counted at two and at three units and every
count (ops, FLOPs, bytes, kernel calls, peak) is taken as ``C + R·B`` for
R units, as the JAX package's ``_accounting_counts`` does from one and
two (here one unit is not on the line: ``count_step``); and the gradient
of a loss is counted once per input signature and replayed for every
later client, step and micro-batch of the same shapes (``_GradMemo``).
The tests hold both against the direct count.

``--mesh``, ``--multi-pod`` and ``--both-meshes`` run a case on the 16 ×
16 or the 2 × 16 × 16 production mesh (``launch/mesh.make_production_mesh``:
a ``fake`` process group, this process rank 0) with the JAX dry run's
layout (``build_sharded_step``): each record holds one device's counts,
its collectives by kind and mesh axis (``collectives``), the fit against
one card and the three roofline terms (``t_compute``, ``t_memory``,
``t_collective``); ``src/repro_torch/DESIGN.md``, "The model axis".
``--fl-sharded`` runs the federation engine's six sharded rounds on a
client mesh of gloo thread ranks and reports each one's all-reduces.
``--serve-engine`` runs ``ServeEngine`` (scan decode and continuous
admission) on reduced archs on real CPU tensors, since the engine reads
back to the host, and reports its shape signatures: one per entry point.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.ops import StepCounter, collective_bytes, tensor_bytes
from repro_torch.analysis import roofline
from repro_torch.analysis.roofline import HW
from repro_torch.configs import ARCH_NAMES, ArchSpec, ModelConfig, get_arch
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.fl import rounds as rounds_lib
from repro_torch.kernels import _build
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import shard_like
from repro_torch.launch.train import pretrain_optimizer
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "DryRunCase", "SHAPE_NAMES", "arguments", "build_sharded_step", "build_step", "case_config", "case_mesh",
    "count_step", "main", "materialize", "run_case", "run_fl_sharded_case", "run_fl_sharded_cases",
    "run_serve_engine_case",
]

SHAPE_NAMES = list(INPUT_SHAPES)
N_CLIENTS = 16  # Mode A's clients a round: the JAX package's single-pod data axis


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape: str
    reduced: bool = False
    scan_rounds: int = 1  # > 1: N Mode-A rounds in one step, batches stacked (N, ...)
    use_flash: bool = True  # serving through K5 and K7, as the serving path runs
    batch: Optional[int] = None  # the shape's global batch unless given
    clients: int = N_CLIENTS  # Mode A's clients a round (at least one a device of the data axes)
    local_steps: Optional[int] = None  # Mode A's local steps, the arch's unless given
    # None: one card; False: the 16 x 16 production mesh; True: 2 x 16 x 16
    multi_pod: Optional[bool] = None
    mesh_shape: Optional[Tuple[int, ...]] = None  # another mesh over (data, model), e.g. (1, 1)
    rules_t: Optional[Dict] = None  # overrides of the arch's train rules (the hillclimb's variants)
    rules_s: Optional[Dict] = None  # and of its serve rules
    fl_over: Optional[Dict] = None  # and of its FL run fields
    cfg_over: Optional[Dict] = None  # and of its model config's fields (after the reduction)
    mesh_device: str = "cpu"  # the device type of a sharded case's (fake) tensors

    @property
    def sharded(self) -> bool:
        return self.multi_pod is not None or self.mesh_shape is not None

    @property
    def mesh_dims(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """The mesh's shape and axis names (of a sharded case)."""
        if self.mesh_shape is not None:
            shape = tuple(self.mesh_shape)
        else:
            shape = (2, 16, 16) if self.multi_pod else (16, 16)
        return shape, (("pod",) if len(shape) == 3 else ()) + ("data", "model")

    @property
    def mesh_name(self) -> str:
        return "x".join(str(n) for n in self.mesh_dims[0]) if self.sharded else "1"

    @property
    def data_devices(self) -> int:
        """Devices along the batch (client) axes: all but ``model``."""
        return math.prod(self.mesh_dims[0][:-1]) if self.sharded else 1


def case_config(case: DryRunCase) -> Tuple[ArchSpec, ModelConfig, Dict]:
    spec = get_arch(case.arch)
    if case.rules_t:
        spec = dataclasses.replace(spec, train_rules=dict(spec.train_rules, **case.rules_t))
    if case.rules_s:
        spec = dataclasses.replace(spec, serve_rules=dict(spec.serve_rules, **case.rules_s))
    if case.fl_over:
        spec = dataclasses.replace(spec, fl=dataclasses.replace(spec.fl, **case.fl_over))
    ishape = INPUT_SHAPES[case.shape]
    cfg = spec.long_context_model() if case.shape == "long_500k" else spec.model
    dims = dict(seq=ishape.seq_len, batch=ishape.global_batch, kind=ishape.kind)
    if case.reduced:
        cfg = cfg.reduced(param_dtype="bfloat16", dtype="bfloat16")
        # a batch of more than one divides over the clients and the data axes
        min_b = max(N_CLIENTS, case.data_devices)
        dims.update(
            seq=min(dims["seq"], 128),
            batch=max(min(dims["batch"], 8), min_b) if ishape.global_batch > 1 else 1,
        )
        if case.sharded:
            # the reduced heads no longer divide the 16-way model axis (JAX's relaxation)
            relax = dict(rwkv_heads=None)
            spec = dataclasses.replace(
                spec, serve_rules=dict(spec.serve_rules, **relax), train_rules=dict(spec.train_rules, **relax)
            )
    if case.cfg_over:
        cfg = dataclasses.replace(cfg, **case.cfg_over)
    if case.batch is not None:
        dims["batch"] = case.batch
    return spec, cfg, dims


def _micro(requested: int, batch: int) -> int:
    """The largest micro-batch count <= ``requested`` that divides ``batch``."""
    micro = max(1, min(requested, batch))
    while batch % micro:
        micro -= 1
    return micro


# ------------------------------------------------------------ step builders


def build_step(
    case: DryRunCase, device="cpu", cfg: Optional[ModelConfig] = None, wrap_loss: Callable = lambda f: f,
    micro_rows: Optional[int] = None,
) -> Tuple[Callable, tuple, Dict]:
    """``(step, args, info)`` of ``case``: ``step(*args)`` is the port's step
    on tensors made on ``device`` (random, from seed 0; fake ones under
    ``FakeTensorMode``).  ``cfg`` replaces the case's model config (the
    dry run's unit-cut copies); ``wrap_loss`` wraps the training loss;
    Mode B's micro-batches split ``micro_rows`` rows (a device's, on a
    mesh; the whole batch by default)."""
    spec, case_cfg, dims = case_config(case)
    cfg = cfg or case_cfg
    b, s = dims["batch"], dims["seq"]
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device)
    vlm = cfg.arch_type == "vlm"  # the frontend stub feeds embeddings

    def inputs(lead: Tuple[int, ...]) -> tuple:
        if vlm and dims["kind"] != "decode":
            embeds = torch.randn(lead + (s, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
            if dims["kind"] == "prefill":
                return (embeds,)
            return embeds, torch.randint(0, cfg.vocab_size, lead + (s,), generator=gen, device=device, dtype=torch.int32)
        width = 1 if dims["kind"] == "decode" else s
        return (torch.randint(0, cfg.vocab_size, lead + (width,), generator=gen, device=device, dtype=torch.int32),)

    info: Dict = {"kind": dims["kind"], "batch": b, "seq": s, "dtype": cfg.dtype}
    if dims["kind"] == "train":

        def raw_loss(p, batch):
            if vlm:
                return T.lm_loss(cfg, p, embeds=batch[0], targets=batch[1])
            return T.lm_loss(cfg, p, batch[0])

        loss = wrap_loss(raw_loss)
        if spec.fl.mode == "client_parallel":
            m, steps = case.clients, case.local_steps or spec.fl.local_steps
            local_b = max(1, b // m)
            micro = _micro(spec.fl.micro_batches, local_b)
            round_step = rounds_lib.build_client_parallel_round(loss, spec.fl.lr, steps, micro_batches=micro)
            info["round_step"] = round_step
            rounds = case.scan_rounds
            batches = inputs(((rounds,) if rounds > 1 else ()) + (m, steps, local_b))
            weights = torch.ones(m, dtype=torch.float32, device=device)
            info.update(fl_mode=spec.fl.mode, clients=m, local_steps=steps, local_batch=local_b,
                        micro_batches=micro, scan_rounds=rounds)
            if rounds == 1:
                return round_step, (params, batches, weights), info

            def scanned(params, batches, weights):
                losses = []
                for i in range(rounds):  # the engine's host loop over rounds
                    params, l = round_step(params, tuple(x[i] for x in batches), weights)
                    losses.append(l)
                return params, torch.stack(losses)

            return scanned, (params, batches, weights), info
        opt = pretrain_optimizer(cfg, spec.optimizer, spec.fl.lr)
        # micro-batches split the rows a device holds (micro_rows; all b on one card)
        micro = _micro(spec.fl.micro_batches, micro_rows or b)
        info.update(fl_mode=spec.fl.mode, optimizer=spec.optimizer, micro_batches=micro, scan_rounds=1)
        step = rounds_lib.build_fedsgd_step(loss, opt, micro_batches=micro)
        return step, (params, opt.init(params), inputs((b,))), info

    info.update(fl_mode="serve", scan_rounds=1, use_flash=case.use_flash)
    caches = T.init_caches(cfg, b, s, device=device)
    if dims["kind"] == "prefill":

        def prefill(params, batch, caches):
            positions = shard_like(torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s), batch[0])
            tokens, embeds = (None, batch[0]) if vlm else (batch[0], None)
            with torch.no_grad():
                hidden, new_caches, _ = T.forward(
                    cfg, params, tokens, T.mrope_streams(cfg, positions), caches, embeds=embeds,
                    use_flash=case.use_flash,
                )
                return T.logits_from_hidden(cfg, params, hidden[:, -1:]), new_caches

        return prefill, (params, inputs((b,)), caches), info

    def decode(params, tokens, caches):
        with torch.no_grad():
            return T.decode_step(cfg, params, tokens, caches, use_flash=case.use_flash)

    return decode, (params, inputs((b,))[0], caches), info


# ------------------------------------------------------------ sharded steps


def case_mesh(case: DryRunCase):
    """The ``DeviceMesh`` of a sharded case (rank 0 of a ``fake`` group:
    ``launch/mesh.make_fake_mesh``), or None for one card."""
    if not case.sharded:
        return None
    from repro_torch.launch.mesh import make_fake_mesh

    return make_fake_mesh(*case.mesh_dims, device=case.mesh_device)


def _to_local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if sh.is_dtensor(x) else x


def _lead_spec(x: torch.Tensor, axis, skip: int = 0) -> sh.Spec:
    """Dim ``skip`` of ``x`` on ``axis``, the others replicated."""
    return sh.Spec((None,) * skip + (axis,) + (None,) * (x.ndim - skip - 1))


def _client_round(round_step: Callable, like: Dict, train_s, serve_s, mesh, clients: int) -> Callable:
    """Mode A on the mesh, the JAX dry run's layout: the round's params
    (train rules) laid out per client by the serve rules, each device
    running its own clients (the client axis over the data axes) through
    ``local_map`` (JAX's ``shard_map``) on DTensors of the ``model`` axis,
    and eq. (6) as each device's share of the weighted sum (its clients'
    average times their share of Σw), summed over the data axes as the
    round's params are laid back out by the train rules."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    model_mesh = mesh["model"]
    shapes = [tuple(x.shape) for x in tree_leaves(like)]
    serve_pl = [sh.placements(x, mesh) for x in sh.spec_leaves(serve_s)]
    train_pl = [sh.placements(x, mesh) for x in sh.spec_leaves(train_s)]
    model_pl = [sh.placements(x, model_mesh) for x in sh.spec_leaves(serve_s)]
    summed = tuple(Partial() if name != "model" else Replicate() for name in names)
    rep = (Replicate(),) * mesh.ndim

    def step(params, batches, weights):
        leaves = [x.redistribute(mesh, pl) for x, pl in zip(tree_leaves(params), serve_pl)]
        if all(mesh.size(i) == 1 for i, name in enumerate(names) if name != "model"):
            # one device along the client axes holds every client: the round itself
            agg, loss = round_step(tree_unflatten(params, leaves), batches, weights)
            return tree_unflatten(params, [x.redistribute(mesh, pl) for x, pl in zip(tree_leaves(agg), train_pl)]), loss
        total = weights.sum().redistribute(mesh, rep)
        n, nb = len(leaves), len(batches)

        def body(*flat):
            local_w, tot = flat[n + nb], flat[n + nb + 1]
            mparams = [sh.from_local_like(t, model_mesh, pl, shp) for t, pl, shp in zip(flat[:n], model_pl, shapes)]
            agg, loss = round_step(tree_unflatten(params, mparams), flat[n : n + nb], local_w)
            share = local_w.sum() / tot
            out = [_to_local((a.float() * share).to(a.dtype)) for a in tree_leaves(agg)]
            return tuple(out) + (_to_local(loss * (local_w.shape[0] / clients)),)

        out_pl = tuple(
            tuple(Partial() if name != "model" else p for name, p in zip(names, pl)) for pl in serve_pl
        ) + (summed,)
        in_pl = tuple(serve_pl) + tuple(tuple(b.placements) for b in batches) + (tuple(weights.placements), rep)
        outs = local_map(body, out_placements=out_pl, in_placements=in_pl, device_mesh=mesh)(
            *leaves, *batches, weights, total
        )
        # local_map takes each output's global shape from even shards: set the true one
        outs = [sh.from_local_like(o.to_local(), mesh, o.placements, shp) for o, shp in zip(outs[:n], shapes)] + [outs[n]]
        new = [x.redistribute(mesh, pl) for x, pl in zip(outs[:n], train_pl)]
        return tree_unflatten(params, new), outs[n].redistribute(mesh, rep)

    return step


def build_sharded_step(
    case: DryRunCase, mesh, device="cpu", cfg: Optional[ModelConfig] = None, wrap_loss: Callable = lambda f: f,
) -> Tuple[Callable, tuple, Dict]:
    """``(step, args, info)`` of a sharded case on ``mesh``: ``build_step``'s
    tensors laid out as DTensors holding this rank's shards, by the JAX dry
    run's layout (``src/repro/launch/dryrun.py``): Mode A as
    :func:`_client_round` with the train rules' params and the clients
    over the data axes; Mode B's params and optimizer state by the train
    rules (``sharding.optimizer_state_specs``) and its batch over the data
    axes; serving by the serve rules, the caches by
    ``sharding.cache_logical_specs`` (batch replicated when it is one).
    ``step`` runs under the rules' activation constraints (Mode A's with
    ``act_batch`` free: the client axis has the data axes) and DTensor's
    implicit replication of plain tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    spec, case_cfg, dims = case_config(case)
    cfg = cfg or case_cfg
    mp = "pod" in mesh.mesh_dim_names
    data_axes = tuple(n for n in mesh.mesh_dim_names if n != "model")
    batch_ax = data_axes if len(data_axes) > 1 else data_axes[0]
    data_devices = math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names) if n != "model")
    case = dataclasses.replace(case, clients=max(case.clients, data_devices))
    step, args, info = build_step(case, device, cfg, wrap_loss, micro_rows=max(1, dims["batch"] // data_devices))
    round_step = info.pop("round_step", None)
    logical = sh.param_logical_specs(cfg)
    info.update(mesh=case.mesh_name, devices=math.prod(mesh.shape))

    def lay(x, spec_):
        return sh.distribute(x, spec_, mesh)

    if dims["kind"] == "train" and spec.fl.mode == "client_parallel":
        params, batches, weights = args
        train_s = sh.specs_from_logical(logical, spec.train_rules, mp)
        serve_s = sh.specs_from_logical(logical, spec.serve_rules, mp)
        skip = 1 if info["scan_rounds"] > 1 else 0
        args = (lay(params, train_s), tuple(lay(x, _lead_spec(x, batch_ax, skip)) for x in batches),
                lay(weights, _lead_spec(weights, batch_ax)))
        one_round = _client_round(round_step, params, train_s, serve_s, mesh, info["clients"])
        rounds = info["scan_rounds"]

        def inner(params, batches, weights):
            if rounds == 1:
                return one_round(params, batches, weights)
            losses = []
            for i in range(rounds):  # the engine's host loop over rounds
                params, l = one_round(params, tuple(x[i] for x in batches), weights)
                losses.append(l)
            return params, torch.stack(losses)

        rules = dict(spec.train_rules, act_batch=None)
    elif dims["kind"] == "train":
        params, opt_state, batch = args
        train_s = sh.specs_from_logical(logical, spec.train_rules, mp)
        args = (lay(params, train_s), lay(opt_state, sh.optimizer_state_specs(spec.optimizer, train_s, cfg)),
                tuple(lay(x, _lead_spec(x, batch_ax)) for x in batch))
        inner, rules = step, spec.train_rules
    else:
        params, batch, caches = args
        b_ax = batch_ax if dims["batch"] > 1 else None
        crules = dict(spec.serve_rules, **({} if b_ax else {"act_batch": None}))
        cspecs = sh.specs_from_logical(sh.cache_logical_specs(cfg), crules, mp)
        lay_b = (lambda x: lay(x, _lead_spec(x, b_ax)))
        batch = tuple(lay_b(x) for x in batch) if isinstance(batch, tuple) else lay_b(batch)
        args = (lay(params, sh.specs_from_logical(logical, spec.serve_rules, mp)), batch, lay(caches, cspecs))
        inner, rules = step, spec.serve_rules

    def sharded(*a):
        with sh.use_rules(rules, mp), implicit_replication():
            return inner(*a)

    return sharded, args, info


def materialize(args, device, seed: int = 0):
    """A sharded case's fake DTensor arguments (``build_sharded_step`` under
    ``FakeTensorMode``) -> real ones on ``device``, laid out the same: each
    leaf's local shard made at its local shape, floats N(0, 0.02²) from
    ``seed``, integers (tokens, positions) zero.  No global tensor is
    formed, so a card runs rank 0's program of a full-width step whose
    whole caches it could not hold."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(x):
        local = x.to_local()
        if local.dtype.is_floating_point:
            real = (torch.randn(tuple(local.shape), generator=gen, device=device) * 0.02).to(local.dtype)
        else:
            real = torch.zeros(tuple(local.shape), dtype=local.dtype, device=device)
        return sh.from_local_like(real, x.device_mesh, x.placements, x.shape)

    return tree_map(one, args)


# ------------------------------------------------------------ counting


def _kernel_state() -> Dict[str, Dict[str, float]]:
    return {"calls": dict(_build.FAKE_CALLS), "flops": dict(_build.FAKE_FLOPS), "bytes": dict(_build.FAKE_BYTES)}


def _signature(tensors) -> tuple:
    return tuple((tuple(x.shape), x.dtype, tuple(getattr(x, "placements", ()))) for x in tensors)


class _GradMemo:
    """Counts a loss's gradient once per input signature and replays it.

    ``wrap(loss_fn)`` is the loss the round builders take.  At a new
    signature of (params, batch) it takes the gradient itself, inside a
    window of the counters, and records what they saw from the loss's
    first op to its last gradient: ops, FLOPs, bytes, kernel calls, the
    peak above the live bytes at entry, and which params got none.  It
    returns the loss through an autograd function whose backward hands the
    caller's ``autograd.grad`` those gradients, with the counters muted.
    At a signature it has seen, the function adds the record to the
    counters, raises the peak by the record's, and its backward returns
    fresh gradients of the params' shapes, or none where none came."""

    def __init__(self, counter: StepCounter):
        self.counter = counter
        self.entries: Dict[tuple, Dict] = {}
        self.real = self.replayed = 0

    def wrap(self, loss_fn: Callable) -> Callable:
        def memo_loss(params, batch):
            live = tree_leaves(params)
            if not torch.is_grad_enabled() or not all(x.requires_grad for x in live):
                return loss_fn(params, batch)
            key = (_signature(live), _signature(tree_leaves(batch)))
            entry, grads, loss = self.entries.get(key), None, None
            if entry is None:
                entry, grads, loss = self._record(loss_fn, params, batch, live)
                self.entries[key] = entry
            else:
                self.replayed += 1
            return _Replay.apply(self, entry, grads, loss, *live)

        return memo_loss

    def _record(self, loss_fn, params, batch, live):
        c = self.counter
        ops0, flops0, bytes0, kernels0 = collections.Counter(c.ops), c.flops, c.bytes_moved, _kernel_state()
        coll0 = len(c.collectives)
        live0 = c.window()
        c.muted = True
        inner = [x.detach().requires_grad_(True) for x in live]
        c.muted = False
        loss = loss_fn(tree_unflatten(params, inner), batch)
        grads = torch.autograd.grad(loss, inner, allow_unused=True)
        k1 = _kernel_state()
        entry = dict(
            ops=c.ops - ops0, flops=c.flops - flops0, bytes=c.bytes_moved - bytes0,
            kernels={f: {n: k1[f][n] - kernels0[f][n] for n in k1[f]} for f in k1},
            peak=c.window_peak - live0, unused=tuple(g is None for g in grads), loss_dtype=loss.dtype,
            collectives=c.collectives[coll0:],
        )
        self.real += 1
        return entry, grads, loss

    def replay(self, entry: Dict) -> None:
        c = self.counter
        c.raise_peak(c.live + entry["peak"])
        c.ops.update(entry["ops"])
        c.bytes_moved += entry["bytes"]
        c.flops += entry["flops"]
        c.collectives.extend(entry["collectives"])
        for field, store in (("calls", _build.FAKE_CALLS), ("flops", _build.FAKE_FLOPS), ("bytes", _build.FAKE_BYTES)):
            for name, n in entry["kernels"][field].items():
                store[name] += n


class _Replay(torch.autograd.Function):
    """The memo's loss: forward and backward muted; ``grads`` (from a
    recording call) or fresh ones (a replay) in the backward."""

    @staticmethod
    def forward(ctx, memo, entry, grads, loss, *live):
        memo.counter.muted = True
        if grads is None:
            memo.replay(entry)
            loss = torch.zeros((), dtype=entry["loss_dtype"], device=live[0].device)
        ctx.memo, ctx.entry, ctx.grads = memo, entry, grads
        ctx.metas = [_meta(x) for x in live]
        return loss.detach()

    @staticmethod
    def backward(ctx, _):
        grads = ctx.grads
        if grads is None:
            grads = tuple(
                None if unused else _fresh(meta) for meta, unused in zip(ctx.metas, ctx.entry["unused"])
            )
        ctx.grads = None
        ctx.memo.counter.muted = False
        return (None, None, None, None) + tuple(grads)


def _meta(x: torch.Tensor) -> tuple:
    """What a replayed gradient of ``x`` is made from."""
    if sh.is_dtensor(x):
        local = x.to_local()
        return tuple(x.shape), x.dtype, local.device, (x.device_mesh, tuple(x.placements), tuple(local.shape))
    return tuple(x.shape), x.dtype, x.device, None


def _fresh(meta: tuple) -> torch.Tensor:
    """An uninitialised gradient of ``_meta``'s tensor: a DTensor laid out
    as the parameter where it is one."""
    shape, dtype, device, layout = meta
    if layout is None:
        return torch.empty(shape, dtype=dtype, device=device)
    mesh, place, local_shape = layout
    return sh.from_local_like(torch.empty(local_shape, dtype=dtype, device=device), mesh, place, shape)


def _count(case: DryRunCase, cfg: ModelConfig, memoize: bool = True) -> Dict:
    """One step of ``case`` at ``cfg`` on fake tensors, counted (one
    device's share on a mesh)."""
    mesh = case_mesh(case)
    with FakeTensorMode():
        counter = StepCounter(mesh)
        memo = _GradMemo(counter)
        wrap = memo.wrap if memoize else (lambda f: f)
        if mesh is None:
            step, args, _ = build_step(case, "cpu", cfg, wrap)
        else:
            step, args, _ = build_sharded_step(case, mesh, case.mesh_device, cfg, wrap)
        _build.reset_fake_calls()
        counter.hold(args)
        with counter:
            out = step(*args)
        kernels = _kernel_state()
        rec = dict(
            flops=counter.flops, bytes_moved=counter.bytes_moved,
            step_peak=counter.peak, output_bytes=sum(tensor_bytes(x) for x in tree_leaves(out)),
            ops=dict(counter.ops), kernel_calls=kernels["calls"], kernel_flops=kernels["flops"],
            kernel_bytes=kernels["bytes"], grads_counted=memo.real, grads_replayed=memo.replayed,
        )
        if mesh is not None:
            rec["collectives"] = collective_bytes(counter.collectives)
        return rec


def _with_units(cfg: ModelConfig, reps: int) -> ModelConfig:
    n = len(cfg.block_pattern)
    return dataclasses.replace(cfg, num_layers=reps * n + cfg.num_layers % n)


def _extrapolate(c2: Dict, c3: Dict, reps: int) -> Dict:
    """Counts at two and three repeat units -> at ``reps``: ``c2 + (reps −
    2)·(c3 − c2)``, key by key in the histograms and kernel tallies."""

    def f(a, b):
        if isinstance(a, dict):
            return {k: f(a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))}
        return a + (reps - 2) * (b - a)

    return {k: f(c2[k], c3[k]) for k in c2}


_WARMED = set()


def _warm(case: DryRunCase) -> None:
    """Run the arch's reduced decode step once per process: the model code
    caches host-side constants on first use (``layers._rounded``), whose
    ops would otherwise be counted in the first count only."""
    if case.arch not in _WARMED:
        _count(DryRunCase(case.arch, "decode_32k", reduced=True), case_config(
            DryRunCase(case.arch, "decode_32k", reduced=True))[1])
        _WARMED.add(case.arch)


def count_step(case: DryRunCase, extrapolate: bool = True, memoize: bool = True) -> Dict:
    """The case's counts at its full depth: counted at two and three
    repeat units and extrapolated when it has more than three
    (``extrapolate``), else counted directly.  From two units on every
    count is affine in the units; one unit is not (the caches' stacked
    positions hold one entry, and a peak can fall elsewhere)."""
    _, cfg, _ = case_config(case)
    reps = cfg.num_layers // len(cfg.block_pattern)
    _warm(case)
    if not extrapolate or reps <= 3:
        return dict(_count(case, cfg, memoize), layer_reps=reps, extrapolated=False)
    out = _extrapolate(_count(case, _with_units(cfg, 2), memoize), _count(case, _with_units(cfg, 3), memoize), reps)
    out["ops"] = {k: v for k, v in out["ops"].items() if v}
    return dict(out, layer_reps=reps, extrapolated=True)


def arguments(case: DryRunCase) -> Dict:
    """The step's setting (``build_step``'s info), its parameter count and
    the bytes of its arguments (one device's shards on a mesh), at full
    depth on fake tensors."""
    mesh = case_mesh(case)
    with FakeTensorMode():
        if mesh is None:
            _, args, info = build_step(case, "cpu")
        else:
            _, args, info = build_sharded_step(case, mesh, case.mesh_device)
        info.pop("round_step", None)
        return dict(info, params=T.param_count(args[0]),
                    argument_bytes=sum(tensor_bytes(x) for x in tree_leaves(args)))


def run_case(case: DryRunCase, extrapolate: bool = True, memoize: bool = True) -> Dict:
    t0 = time.perf_counter()
    rec: Dict = {"case": "arch", "arch": case.arch, "shape": case.shape, "reduced": case.reduced,
                 "card": HW.NAME, "mesh": case.mesh_name}
    try:
        rec.update(arguments(case))
        counts = count_step(case, extrapolate, memoize)
        rec.update(counts)
        rec["flops"] = counts["flops"] + sum(counts["kernel_flops"].values())
        rec["flops_counted"] = counts["flops"]
        rec["bytes_moved"] = counts["bytes_moved"] + sum(counts["kernel_bytes"].values())
        # cuBLAS's workspaces: the calling thread's, and for a step that
        # takes gradients that of autograd's thread for the card
        rec["workspace_bytes"] = HW.CUBLAS_WORKSPACE * (2 if rec["kind"] == "train" else 1)
        rec["peak_bytes"] = rec["argument_bytes"] + counts["step_peak"] + rec["workspace_bytes"]
        rec["n_ops"] = sum(counts["ops"].values())
        rec["card_bytes"] = HW.HBM_BYTES
        rec["fits_one_card"] = rec["peak_bytes"] <= HW.HBM_BYTES
        rec["cards_needed"] = math.ceil(rec["peak_bytes"] / HW.HBM_BYTES)
        if rec["kind"] == "decode" and case.use_flash:
            # K5 is skipped where the caches' sequence is sharded (launch/sharding.py)
            attn = any(b.split("+")[0] in ("attn", "swa", "local") for b in case_config(case)[1].layer_types())
            rec["decode_attention"] = ("flash_decode" if counts["kernel_calls"].get("flash_decode") else "plain") \
                if attn else None
        rec.update(roofline.step_terms(rec, case.mesh_dims if case.sharded else None))
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


# ----------------------------------------------------- sharded FL engine


def run_fl_sharded_case(num_devices: int = 64, clients: int = 256, clients_per_round: int = 32, rounds: int = 4,
                        cohort_cap: Optional[int] = None, staleness_bound: Optional[int] = None,
                        scenario: Optional[str] = None, candidate_frac: Optional[float] = None,
                        faults: Optional[str] = None, aggregator: str = "mean", local_algo: str = "fedavg",
                        prox_mu: Optional[float] = None, feddyn_alpha: Optional[float] = None) -> Dict:
    """The federation engine's sharded round on a client mesh of
    ``num_devices`` gloo ranks (threads of this process,
    ``launch/mesh.run_ranks``): the JAX dry run's ``run_fl_sharded_case``
    (its federation, a linear model over 256 clients, and its variants:
    resident, capacity slots, bounded staleness, the funnel, faults with a
    robust aggregator, FedDyn), run for ``rounds`` rounds on the port's
    engine (``engine.init_server_state(mesh=)``, ``make_round_fn(mesh=)``).
    The record holds the all-reduces a round and their bytes, rank 0's."""
    from repro_torch.core import selection as selection_lib
    from repro_torch.fl import engine as engine_lib
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    case = "fl_sharded_engine"
    if cohort_cap is not None:
        case += "_slotted"
    elif staleness_bound is not None:
        case += "_stale"
    elif candidate_frac is not None:
        case += "_funnel"
    elif faults is not None or aggregator != "mean":
        case += "_faulty"
    elif local_algo != "fedavg":
        case += f"_{local_algo}"
    rec: Dict = {"case": case, "mesh": f"{num_devices}x1(clients)", "backend": "gloo", "ranks": "threads",
                 "clients": clients, "clients_per_round": clients_per_round, "cohort_cap": cohort_cap,
                 "staleness_bound": staleness_bound, "scenario": scenario, "candidate_frac": candidate_frac,
                 "faults": faults, "aggregator": aggregator, "local_algo": local_algo, "scan_rounds": rounds}
    try:
        feat, n_c, ncls = 32, 8, 10
        rng = np.random.default_rng(0)
        xs = torch.tensor(rng.normal(size=(clients, n_c, feat)).astype("float32"))
        ys = torch.tensor(rng.integers(0, ncls, size=(clients, n_c)))
        params = {"w": torch.tensor(0.01 * rng.normal(size=(feat, ncls)).astype("float32")),
                  "b": torch.zeros(ncls)}

        def loss_fn(p, x, y):
            logp = torch.log_softmax(x @ p["w"] + p["b"], dim=-1)
            return -torch.mean(logp.gather(-1, y[..., None].long()))

        cfg = engine_lib.FLConfig(
            num_clients=clients, clients_per_round=clients_per_round, local_epochs=2, lr=0.1, rounds=rounds,
            eval_every=rounds, num_classes=ncls, seed=0, cohort_cap=cohort_cap, staleness_bound=staleness_bound,
            scenario=scenario, candidate_frac=candidate_frac, faults=faults, aggregator=aggregator,
            local_algo=local_algo, prox_mu=prox_mu, feddyn_alpha=feddyn_alpha,
        )

        def rank(mesh):
            strat = selection_lib.DPPSelection()
            with torch.no_grad():
                l0 = torch.stack([loss_fn(params, x, y) for x, y in zip(xs, ys)])
            state = engine_lib.init_server_state(cfg, params, xs, ys, xs.mean(dim=1), l0, strat, device="cpu",
                                                 loss_fn=loss_fn, mesh=mesh)
            fn = engine_lib.make_round_fn(cfg, loss_fn, (strat,), mesh=mesh)
            mesh.reset_counts()
            final, outs = engine_lib.run_scanned(fn, state, rounds)
            return dict(all_reduces=mesh.all_reduce_calls, bytes=mesh.all_reduce_bytes,
                        candidates=None if state.candidates is None else int(state.candidates.shape[0]),
                        finite=bool(torch.isfinite(outs["loss"]).any()))

        res = run_ranks(num_devices, rank, "cpu")
        r0 = res[0]
        rec.update(all_reduces_per_round=r0["all_reduces"] / rounds, all_reduce_bytes_per_round=r0["bytes"] / rounds,
                   candidates=r0["candidates"], ranks_agree=all(r["all_reduces"] == r0["all_reduces"] for r in res))
        rec["ok"] = rec["ranks_agree"] and r0["finite"]
        if not rec["ok"]:
            rec["error"] = "ranks disagree on their all-reduces, or no finite loss"
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def run_fl_sharded_cases(devices: int = 64, cohort_cap: int = 2, staleness_bound: int = 2,
                         candidate_frac: float = 0.25, clients: int = 256, rounds: int = 4) -> List[Dict]:
    """JAX's six ``--fl-sharded`` cases, with its defaults."""
    common = dict(num_devices=devices, clients=clients, rounds=rounds, clients_per_round=min(32, clients // 2))
    return [
        run_fl_sharded_case(**common),
        run_fl_sharded_case(**dict(common, clients_per_round=cohort_cap), cohort_cap=cohort_cap),
        run_fl_sharded_case(**common, staleness_bound=staleness_bound, scenario="heavy_tail"),
        run_fl_sharded_case(**common, candidate_frac=candidate_frac),
        run_fl_sharded_case(**common, faults="chaos", aggregator="trimmed_mean"),
        run_fl_sharded_case(**common, local_algo="feddyn", feddyn_alpha=0.01),
    ]


def _fl_line(rec: Dict) -> str:
    extra = "".join((
        f" cap={rec['cohort_cap']}" if rec["cohort_cap"] is not None else "",
        f" stale<={rec['staleness_bound']}({rec['scenario']})" if rec["staleness_bound"] is not None else "",
        f" Q={rec.get('candidates')}({rec['candidate_frac']})" if rec["candidate_frac"] is not None else "",
        f" faults={rec['faults']}/{rec['aggregator']}" if rec["faults"] is not None else "",
        f" algo={rec['local_algo']}" if rec["local_algo"] != "fedavg" else "",
    ))
    tail = (f"  all-reduces/round {rec['all_reduces_per_round']:g} ({rec['all_reduce_bytes_per_round']:g} B)"
            if rec["ok"] else f"  {rec['error'][:160]}")
    return (f"[{'OK ' if rec['ok'] else 'FAIL'}] {rec['case']} {rec['mesh']:14s} {rec['backend']} "
            f"C={rec['clients']} k={rec['clients_per_round']}{extra} {rec['total_s']:7.1f}s{tail}")


# ----------------------------------------------------- serving engine


def run_serve_engine_case(arch: str, batch: int = 4, prompt: int = 8, gen: int = 8) -> Dict:
    """``ServeEngine`` on a reduced arch on the CPU (real tensors): its scan
    decode over every slot and one continuous admission into a slot freed
    by a harvest (``batch + 1`` requests), through K5 and K7's plain
    versions.  ``ok`` when every request finished with its budget and each
    entry point saw one shape signature (``compile_counts``)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    rec: Dict = {"case": "serve_engine", "arch": arch, "batch": batch, "prompt": prompt, "gen": gen}
    try:
        cfg = get_arch(arch).model.reduced(param_dtype="float32", dtype="float32", remat=False)
        scfg = ServeConfig(batch=batch, cache_len=prompt + gen, max_new=gen, use_flash=True)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        engine = ServeEngine(cfg, scfg, params, prompt_len=prompt, seed=0)
        rng = np.random.default_rng(0)
        for _ in range(batch + 1):
            engine.submit(rng.integers(0, cfg.vocab_size, prompt), gen)
        done = engine.run()
        rec["compile_counts"] = engine.compile_counts()
        rec["finished"] = len(done)
        rec["ok"] = len(done) == batch + 1 and all(len(f.tokens) == gen for f in done) and all(
            n == 1 for n in rec["compile_counts"].values()
        )
        if not rec["ok"]:
            rec["error"] = f"finished {len(done)} of {batch + 1}, signatures {rec['compile_counts']}"
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


# ------------------------------------------------------------------ CLI


def _append(path: Optional[str], rec: Dict) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--sweep", action="store_true", help="all arch x shapes")
    ap.add_argument("--reduced", action="store_true", help="reduced configs + tiny shapes (CI smoke)")
    ap.add_argument("--scan-rounds", type=int, default=1,
                    help="N Mode-A rounds in one step, batches stacked on a leading (N,) axis")
    ap.add_argument("--serve-engine", action="store_true",
                    help="run ServeEngine's scan decode and continuous admission on reduced archs (CPU)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes, one case each (default: half the host's cores)")
    ap.add_argument("--mesh", action="store_true", help="one device's share on the 16 x 16 production mesh")
    ap.add_argument("--multi-pod", action="store_true", help="one device's share on the 2 x 16 x 16 mesh")
    ap.add_argument("--both-meshes", action="store_true", help="each case on the 16 x 16 and the 2 x 16 x 16 mesh")
    ap.add_argument("--mesh-device", default="cpu", choices=("cpu", "cuda"),
                    help="the device type of the mesh's fake tensors (cuda: the collectives the card issues)")
    ap.add_argument("--fl-sharded", action="store_true",
                    help="the federation engine's six sharded rounds on a client mesh instead of an arch case")
    ap.add_argument("--fl-devices", type=int, default=64, help="client-mesh ranks for --fl-sharded")
    ap.add_argument("--fl-cohort-cap", type=int, default=2,
                    help="slots a rank (and the cohort's size) of the --fl-sharded capacity-slot case")
    ap.add_argument("--fl-staleness-bound", type=int, default=2,
                    help="staleness bound of the --fl-sharded bounded-staleness case")
    ap.add_argument("--fl-candidate-frac", type=float, default=0.25,
                    help="candidate fraction of the --fl-sharded funnel case")
    args = ap.parse_args(argv)

    if args.fl_sharded:
        failed = False
        for rec in run_fl_sharded_cases(args.fl_devices, args.fl_cohort_cap, args.fl_staleness_bound,
                                        args.fl_candidate_frac):
            print(_fl_line(rec), flush=True)
            if not rec["ok"]:
                failed = True
                print(rec.get("traceback", "")[-800:])
            _append(args.out, rec)
        if failed:
            raise SystemExit(1)
        return

    if args.serve_engine:
        # one cache family each: dense GQA KV, the RWKV state, SWA ring + MoE
        archs = [args.arch] if args.arch else ["smollm-360m", "rwkv6-7b", "mixtral-8x7b"]
        failed = False
        for arch in archs:
            rec = run_serve_engine_case(arch)
            print(f"[{'OK ' if rec['ok'] else 'FAIL'}] serve_engine {arch:28s} b={rec['batch']} p={rec['prompt']} "
                  f"g={rec['gen']} {rec['total_s']:7.1f}s  "
                  + (f"signatures {rec['compile_counts']}" if rec["ok"] else rec["error"][:160]))
            failed |= not rec["ok"]
            _append(args.out, rec)
        if failed:
            raise SystemExit(1)
        return

    if args.sweep:
        pairs = [(a, s) for a in ARCH_NAMES for s in SHAPE_NAMES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --sweep, are required")
        pairs = [(args.arch, args.shape)]
    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok") and r.get("case") == "arch":
                    done.add((r["arch"], r["shape"], r.get("mesh", "1"), r.get("reduced", False)))
    meshes = (False, True) if args.both_meshes else (True,) if args.multi_pod else (False,) if args.mesh else (None,)
    every = [DryRunCase(arch, shape, reduced=args.reduced, scan_rounds=args.scan_rounds, multi_pod=mp,
                        mesh_device=args.mesh_device) for arch, shape in pairs for mp in meshes]
    cases = [c for c in every if (c.arch, c.shape, c.mesh_name, c.reduced) not in done]
    for c in every:
        if (c.arch, c.shape, c.mesh_name, c.reduced) in done:
            print(f"[skip] {c.arch} {c.shape} {c.mesh_name} (in {args.out})")
    jobs = min(len(cases), args.jobs or max(1, (os.cpu_count() or 1) // 2))  # one process a case
    if jobs > 1:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"))
        records = pool.map(run_case, cases)
    else:
        pool, records = None, map(run_case, cases)
    failed = False
    for case, rec in zip(cases, records):
        if rec["ok"]:
            fit = "fits one card" if rec["fits_one_card"] else f"needs {rec['cards_needed']} cards"
            where = f"{case.mesh_name:8s} " if case.sharded else ""
            coll = f"  collectives {rec['collectives']['total']:.3e} B" if case.sharded else ""
            print(f"[OK ] {case.arch:28s} {case.shape:12s} {where}{rec['total_s']:7.1f}s  params {rec['params']:.3e}  "
                  f"flops {rec['flops']:.3e}  peak {rec['peak_bytes'] / 2**30:.2f} GiB  {fit}{coll}", flush=True)
        else:
            failed = True
            print(f"[FAIL] {case.arch:28s} {case.shape:12s} {case.mesh_name:8s} {rec['total_s']:7.1f}s  "
                  f"{rec['error'][:160]}")
            print(rec.get("traceback", "")[-800:], flush=True)
        _append(args.out, rec)
    if pool is not None:
        pool.shutdown()
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
