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

:func:`op_histogram` reads a dry-run record's histogram back, most
frequent first.  The HLO module's other measure, ``collective_bytes``, has
no counterpart yet: one card runs no collective (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["StepCounter", "card_temporaries", "op_histogram", "tensor_bytes"]

# results allocated without being written: they move no bytes
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: its elements, or the span its
    strides reach when fewer (an expanded view reads each element once)."""
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


class StepCounter(TorchDispatchMode):
    """Counts aten ops, bytes moved and live bytes while it is active.

    ``ops``: op name (``aten.mm``) -> calls; ``flops``: their FLOPs;
    ``bytes_moved``: the ops' argument and result bytes; ``live`` and ``peak``: bytes of the
    storages made while active and still alive, and their most.
    ``window()`` starts a sub-peak (``window_peak``) at the current live
    bytes.  While ``muted`` ops are not counted, but the storages they make
    are still tracked.  ``hold(args)`` leaves the arguments' storages out."""

    def __init__(self):
        super().__init__()
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
            self._seen[x.untyped_storage()] = 0

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
        out = func(*args, **(kwargs or {}))
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
