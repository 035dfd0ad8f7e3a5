"""What a step dispatches: aten ops, the bytes they move and the memory
they hold, counted by a dispatch mode (the port's counterpart of the JAX
package's ``analysis/hlo.py``, which reads a compiled HLO module; the port
compiles nothing, so it counts the ops as they are dispatched).

:class:`StepCounter` is a ``TorchDispatchMode``.  For each aten op it adds
one to the op's count, adds its FLOPs by ``FlopCounterMode``'s formulas
(its ``flop_registry``: matmuls, convolutions, attention), adds the bytes
the op reads and writes (each tensor argument and result once, views and
uninitialised allocations moving none) and, for every result whose
storage it has not seen, that storage's bytes to the live total, dropping
them when the storage is freed; the most live bytes are the step's peak
above its arguments.  Where a kernel of PyTorch's on the card allocates
buffers of its own while it runs (:func:`card_temporaries`), the peak
counts them at that op.  It runs over
real tensors or fake ones (``torch._subclasses.fake_tensor``: shapes and
dtypes, no storage), where the sizes are those the real step would take.

On a sharded step (DTensors, ``launch/sharding.py``) the counter counts
one device's share: an op on DTensors is handed back to DTensor
(``NotImplemented``, as ``CommDebugMode`` does), which runs it as ops on
this rank's local tensors and, where the placements call for it, as
``_c10d_functional`` collectives on them; the counter sees and counts
those, at the local shapes.  Each collective is recorded with its kind,
the mesh axis of its group and its bytes by the JAX package's per-device
estimators (``analysis/hlo.py``): :func:`collective_bytes` sums them.
What DTensor runs to infer a result's global shape is not counted
(``_mute_meta_propagation``).

:func:`op_histogram` reads a dry-run record's histogram back, most
frequent first.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["StepCounter", "card_temporaries", "collective_bytes", "op_histogram", "tensor_bytes"]

# results allocated without being written: they move no bytes
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


# ``_c10d_functional`` op -> the collective's kind, JAX's names
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's shard-to-shard move on a CUDA mesh
}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (this rank's storage); any other tensor."""
    local = getattr(t, "_local_tensor", None)
    return t if local is None else local


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: its elements, or the span its
    strides reach when fewer (an expanded view reads each element once);
    of a DTensor, its local shard's."""
    t = _local(t)
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((size - 1) * abs(stride) for size, stride in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


def card_temporaries(func, args) -> int:
    """Bytes that ``func``'s CUDA kernel allocates for itself while it runs,
    beside its arguments and results, unseen by a dispatch mode.  On the
    H100 (PyTorch 2.11, CUDA 12.8) ``_softmax_backward_data`` forms its
    grad times the softmax output, of the grad's bytes, and makes it
    contiguous, a second such buffer, where the grad is not contiguous (as
    the plain attention's backward hands it); ``chip_smoke.py`` phase 7 and
    ``tests/test_torch_cuda.py`` read both back on the card.  Other ops'
    buffers are not counted: none fell at a measured step's peak."""
    if func.overloadpacket == torch.ops.aten._softmax_backward_data:
        return tensor_bytes(args[0]) * (1 if args[0].is_contiguous() else 2)
    return 0


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def collective_bytes(calls: Iterable[Tuple[str, str, float]]) -> Dict[str, Dict[str, float]]:
    """Per-device collective traffic of ``calls`` ((kind, mesh axis,
    bytes) as :class:`StepCounter` records them): bytes ``by_kind`` and
    ``by_axis``, ``calls`` by kind, and the ``total``."""
    by_kind: Dict[str, float] = collections.defaultdict(float)
    by_axis: Dict[str, float] = collections.defaultdict(float)
    n: Dict[str, int] = collections.defaultdict(int)
    for kind, axis, b in calls:
        by_kind[kind] += b
        by_axis[axis] += b
        n[kind] += 1
    return {"by_kind": dict(by_kind), "by_axis": dict(by_axis), "calls": dict(n),
            "total": float(sum(by_kind.values()))}


def _collective(func, args, out, axes: Dict[str, str]) -> Optional[Tuple[str, str, float]]:
    """(kind, axis, bytes) of a ``_c10d_functional`` collective, by JAX's
    per-device estimators: all-reduce 2 × size, all-gather size(result),
    reduce-scatter size × group (its input), all-to-all size(result)."""
    kind = COLLECTIVE_KINDS.get(func.overloadpacket.__name__)
    if kind is None:
        return None
    group = args[-1] if isinstance(args[-1], str) else None
    axis = axes.get(group, group or "?")
    if kind == "all-reduce":
        b = 2.0 * sum(tensor_bytes(t) for t in _tensors(out))
    elif kind == "reduce-scatter":
        b = float(sum(tensor_bytes(t) for t in _tensors(args[0])))
    else:
        b = float(sum(tensor_bytes(t) for t in _tensors(out)))
    return kind, axis, b


_PROPAGATING = [0]  # > 0 while DTensor infers an op's global output on fake tensors


def _mute_meta_propagation() -> None:
    """DTensor infers an op's global output shape by running the op on fake
    tensors of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, once per op signature), under the
    same mode stack: those ops are no device's, so the counter skips what
    runs inside it.  Installed once, when a counter is made."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    inner = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(inner, "_step_counter_muted", False):
        return

    def propagate(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return inner(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1

    propagate._step_counter_muted = True
    ShardingPropagator._propagate_tensor_meta_non_cached = propagate


def mesh_axes(mesh) -> Dict[str, str]:
    """Process-group names -> mesh axis names: ``mesh``'s dims, and those
    of every fake mesh of the process (``launch/mesh.GROUP_AXES``; DTensor
    may run a plan it cached for an equal mesh on that mesh's groups)."""
    if mesh is None:
        return {}
    from repro_torch.launch.mesh import GROUP_AXES

    return dict(GROUP_AXES, **{mesh.get_group(i).group_name: name for i, name in enumerate(mesh.mesh_dim_names)})


class StepCounter(TorchDispatchMode):
    """Counts aten ops, bytes moved and live bytes while it is active.

    ``ops``: op name (``aten.mm``) -> calls; ``flops``: their FLOPs;
    ``bytes_moved``: the ops' argument and result bytes; ``live`` and ``peak``: bytes of the
    storages made while active and still alive, and their most.
    ``window()`` starts a sub-peak (``window_peak``) at the current live
    bytes.  While ``muted`` ops are not counted, but the storages they make
    are still tracked.  ``hold(args)`` leaves the arguments' storages out.
    On DTensors it counts this rank's local ops (module docstring), and
    ``collectives`` lists each collective as (kind, mesh axis, bytes),
    the axis named by ``mesh`` (a ``DeviceMesh``)."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.distributed.tensor import DTensor

        _mute_meta_propagation()
        self._dtensor = DTensor
        self.collectives: List[Tuple[str, str, float]] = []
        self._axes = mesh_axes(mesh)
        self.ops: collections.Counter = collections.Counter()
        self.flops = 0
        self.bytes_moved = 0
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.live = 0
        self.peak = 0
        self.window_peak = 0
        self.muted = False
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def hold(self, tree) -> None:
        """Storages of ``tree`` (the step's arguments) are not the step's:
        views of them made while active add nothing."""
        for x in _tensors(tree):
            self._seen[_local(x).untyped_storage()] = 0

    def window(self) -> int:
        self.window_peak = self.live
        return self.live

    def raise_peak(self, live: int) -> None:
        """Record that the live bytes reached ``live`` (a replayed step's)."""
        self.peak = max(self.peak, live)
        self.window_peak = max(self.window_peak, live)

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.raise_peak(self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops and collectives, counted here
        out = func(*args, **(kwargs or {}))
        if _PROPAGATING[0]:
            return out
        if func.namespace in ("_c10d_functional", "_dtensor"):
            call = _collective(func, args, out, self._axes)
            if call is not None and not self.muted:
                self.ops[str(func.overloadpacket)] += 1
                self.collectives.append(call)
            for t in _tensors(out):
                self._track(t)
            return out
        if func.namespace != "aten":  # prim.device and the like: queries, not ops
            return out
        if not self.muted:
            packet = func.overloadpacket
            self.ops[str(packet)] += 1
            formula = self._formulas.get(packet)
            if formula is not None:
                self.flops += formula(*args, **(kwargs or {}), out_val=out)
            if not func.is_view and packet.__name__ not in _UNWRITTEN:
                self.bytes_moved += sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
                self.bytes_moved += sum(tensor_bytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        extra = card_temporaries(func, args)
        if extra:
            self.raise_peak(self.live + extra)
        return out


def op_histogram(record: Dict, top: Optional[int] = None) -> List[Tuple[str, int]]:
    """A dry-run record's aten-op counts, most frequent first (ties by
    name), the first ``top`` of them when given."""
    hist = sorted(record.get("ops", {}).items(), key=lambda kv: (-kv[1], kv[0]))
    return hist if top is None else hist[:top]
