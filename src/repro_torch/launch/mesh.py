"""The federation's client mesh: D ``torch.distributed`` ranks, each holding
C/D resident clients.

JAX's ``make_client_mesh`` returns a 1-D device mesh that one controller
drives with ``shard_map``.  Here a rank is a caller of its own: every rank
runs the same engine on its own copy of the replicated server state and
its own slice of the client-sharded fields, and the ranks meet only in the
collective a :class:`ClientMesh` makes.  The mesh is the only place that
calls one: :meth:`ClientMesh.all_reduce` sums a flat tensor across the
ranks and counts its calls, so a test or a trace can hold a round to its
one all-reduce (JAX's single ``psum``).

Backends: NCCL for ranks on CUDA devices (rank r on ``cuda:r``), gloo for
``device="cpu"``; there is no fallback from one to the other.  A world of
size 1 still runs a real process group.  The ranks of one process run in
threads (:func:`run_ranks`), each with a process group built on one shared
``HashStore``; on the card more ranks than visible GPUs raise, as JAX's
mesh does with more devices than it sees.

Thread ranks serve the CPU tests (D gloo ranks) and one card (one NCCL
rank).  The ranks share one interpreter, so their eager dispatch takes
turns on its lock: on D cards the host work of a round is likely to run
one rank at a time, and seconds a round on D cards is not measured.  The
kernels' launch counts (``kernels/_build.LAUNCHES``) are the process's,
summed over its ranks.

``make_production_mesh`` and the roofline's TPU constants (``HW``) belong
to the model-axis half of the mesh work and are not here; the port's
roofline has its own ``HW`` (``analysis/roofline.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["ClientMesh", "make_client_mesh", "run_ranks"]

# a rank that dies before a collective leaves the others waiting: both
# backends give up after this long instead of their own defaults (gloo's
# 30 minutes, NCCL's 10)
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """One rank of the client mesh: ``(group, rank, size, device)``.

    ``all_reduce_calls`` counts :meth:`all_reduce` calls since the last
    :meth:`reset_counts` (or since the mesh was made)."""

    group: Any  # a torch.distributed ProcessGroup (gloo or NCCL)
    rank: int
    size: int
    device: torch.device
    backend: str
    all_reduce_calls: int = 0

    def all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` (a tensor on this rank's device) over the ranks, in
        place, and return it.  One call is one collective."""
        if flat.device != self.device:
            raise ValueError(f"all_reduce of a tensor on {flat.device}; this rank computes on {self.device}")
        self.all_reduce_calls += 1
        self.group.allreduce([flat]).wait()
        return flat

    def reset_counts(self) -> None:
        self.all_reduce_calls = 0

    def close(self) -> None:
        """Shut the process group down (its NCCL communicator or gloo
        connections); the mesh makes no collective after this."""
        self.group.shutdown()

    def residents(self, num_clients: int) -> Tuple[int, int]:
        """This rank's resident global ids ``[lo, hi)``: rank r holds
        ``[r·C/D, (r+1)·C/D)`` (JAX's shard layout).  C must divide by D."""
        if num_clients % self.size:
            raise ValueError(f"num_clients={num_clients} not divisible by the client mesh's {self.size} ranks")
        c_loc = num_clients // self.size
        return self.rank * c_loc, (self.rank + 1) * c_loc

    def assemble(self, rows: torch.Tensor, num_clients: int) -> torch.Tensor:
        """The (C, ...) tensor whose rows ``[lo, hi)`` are this rank's
        ``rows`` (C/D, ...), the other ranks' rows theirs: zero-filled
        rows summed by one :meth:`all_reduce`, in fp32 (exact: each entry
        is one rank's value plus zeros)."""
        lo, hi = self.residents(num_clients)
        if rows.shape[0] != hi - lo:
            raise ValueError(f"{rows.shape[0]} rows for the {hi - lo} residents of rank {self.rank}")
        full = torch.zeros((num_clients,) + tuple(rows.shape[1:]), dtype=torch.float32, device=self.device)
        full[lo:hi] = rows.float()
        return self.all_reduce(full.reshape(-1)).reshape(full.shape).to(rows.dtype)


def make_client_mesh(
    num_devices: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    *,
    rank: int = 0,
    store: Optional[Any] = None,
) -> ClientMesh:
    """Rank ``rank`` of a client mesh of ``num_devices`` ranks (default 1).

    ``device`` is the device type the ranks compute on (default ``cuda``,
    raising without a card): on ``cuda`` rank r computes on ``cuda:r`` over
    NCCL, and ``num_devices`` above the visible card count raises; on
    ``cpu`` every rank computes on the CPU over gloo.  The ranks of one
    mesh share ``store`` (a ``torch.distributed`` Store; a fresh
    ``HashStore`` when None, which only a mesh of one rank can use)."""
    n = 1 if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"a client mesh needs at least one rank, got {n}")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} ranks")
    if store is None:
        if n > 1:
            raise ValueError("the ranks of a mesh of more than one rank must share a store")
        store = dist.HashStore()
    kind = resolve_device(device)
    if kind.type == "cuda":
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"requested {n} ranks, only {visible} CUDA devices visible (one rank a card)")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a client mesh on CUDA devices needs it")
        dev = torch.device("cuda", rank)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = TIMEOUT
        group = dist.ProcessGroupNCCL(store, rank, n, opts)
        backend = "nccl"
    elif kind.type == "cpu":
        dev = torch.device("cpu")
        group = dist.ProcessGroupGloo(store, rank, n, TIMEOUT)
        backend = "gloo"
    else:
        raise ValueError(f"a client mesh runs on cuda or cpu, not {kind.type}")
    return ClientMesh(group=group, rank=rank, size=n, device=dev, backend=backend)


def run_ranks(
    num_ranks: int,
    fn: Callable[[ClientMesh], Any],
    device: Optional[Union[str, torch.device]] = None,
) -> List[Any]:
    """``fn(mesh)`` on each rank of a fresh mesh of ``num_ranks`` ranks,
    one thread a rank (rank 0 in the calling thread) -> the ranks' results
    in rank order.  Each mesh is closed when its rank's ``fn`` returns.  A
    rank's exception is raised here after every thread has ended (the
    others fail at their next collective, after :data:`TIMEOUT`)."""
    if num_ranks == 1:
        mesh = make_client_mesh(1, device)
        try:
            return [fn(mesh)]
        finally:
            mesh.close()
    store = dist.HashStore()
    results: List[Any] = [None] * num_ranks
    errors: List[Optional[BaseException]] = [None] * num_ranks

    def rank_main(r: int) -> None:
        try:
            mesh = make_client_mesh(num_ranks, device, rank=r, store=store)
            if mesh.device.type == "cuda":
                torch.cuda.set_device(mesh.device)
            try:
                results[r] = fn(mesh)
            finally:
                mesh.close()
        except BaseException as e:  # re-raised in the caller below
            errors[r] = e

    threads = [threading.Thread(target=rank_main, args=(r,), name=f"client-rank-{r}") for r in range(1, num_ranks)]
    for th in threads:
        th.start()
    rank_main(0)
    for th in threads:
        th.join()
    for e in errors:
        if e is not None:
            raise e
    return results
