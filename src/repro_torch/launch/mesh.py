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

``make_production_mesh`` is the model axis's mesh: the JAX package's
16 × 16 (``data``, ``model``) or 2 × 16 × 16 (``pod``, ``data``, ``model``)
layout as a ``DeviceMesh`` over a process group of ``torch.distributed``'s
``fake`` backend, in which this process is rank 0 of the mesh (of 512
ranks, a 16 × 16 mesh taking the first 256).  One
process runs one device's share of a sharded program (DTensors holding
rank 0's shards) and no data crosses: a collective returns at once, its
tensors as they were.  The dry run (``launch/dryrun.py``) counts that
share; ``chip_smoke.py`` runs it on the card.  The mesh sets the
process's default group (a ``ClientMesh`` builds its own groups and never
reads it) until ``release_fake_meshes`` destroys it.  JAX's TPU constants
(``HW``) are not ported: the roofline's H100 ``HW``
(``analysis/roofline.py``) is the one definition.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = [
    "ClientMesh", "make_client_mesh", "make_fake_mesh", "make_production_mesh", "release_fake_meshes", "run_ranks",
]

# a rank that dies before a collective leaves the others waiting: both
# backends give up after this long instead of their own defaults (gloo's
# 30 minutes, NCCL's 10)
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """One rank of the client mesh: ``(group, rank, size, device)``.

    ``all_reduce_calls`` counts :meth:`all_reduce` calls since the last
    :meth:`reset_counts` (or since the mesh was made), and
    ``all_reduce_bytes`` the bytes of the tensors they summed."""

    group: Any  # a torch.distributed ProcessGroup (gloo or NCCL)
    rank: int
    size: int
    device: torch.device
    backend: str
    all_reduce_calls: int = 0
    all_reduce_bytes: int = 0

    def all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` (a tensor on this rank's device) over the ranks, in
        place, and return it.  One call is one collective."""
        if flat.device != self.device:
            raise ValueError(f"all_reduce of a tensor on {flat.device}; this rank computes on {self.device}")
        self.all_reduce_calls += 1
        self.all_reduce_bytes += flat.numel() * flat.element_size()
        self.group.allreduce([flat]).wait()
        return flat

    def reset_counts(self) -> None:
        self.all_reduce_calls = self.all_reduce_bytes = 0

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


# ranks a fake mesh may span: the multi-pod mesh's; a smaller mesh takes the first ones
FAKE_WORLD = 512
# the fake group's blocks of FAKE_WORLD ranks: the meshes made between two
# releases span one block, whose first rank this process is
FAKE_BLOCKS = 1024
_BLOCK = [0]
# one mesh for each (shape, axes, device type): DTensor caches its plans by
# mesh equality, so a second equal mesh would run on the first one's groups
_FAKE_MESHES: dict = {}
# process-group name -> the mesh axis it spans, for every fake mesh made
GROUP_AXES: dict = {}


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str], device: Union[str, torch.device] = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the first
    ``prod(shape)`` ranks (row-major) of a block of :data:`FAKE_WORLD` ranks
    of a ``fake`` process group, in which this process is the block's first
    rank (mesh coordinate 0 on every axis).  The group is made the default
    one on the first call and kept until :func:`release_fake_meshes`: every
    mesh shares it, and a mesh asked for again is the same object.
    ``device`` is the device type its tensors live on (``cpu`` or
    ``cuda``; ``cuda`` makes the first card the current one)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if n > FAKE_WORLD:
        raise ValueError(f"a mesh of {n} devices is larger than the fake world's {FAKE_WORLD}")
    base = _BLOCK[0] * FAKE_WORLD
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=base, world_size=FAKE_WORLD * FAKE_BLOCKS)
    elif dist.get_backend() != "fake" or dist.get_world_size() != FAKE_WORLD * FAKE_BLOCKS:
        raise RuntimeError(
            f"the default process group is {dist.get_backend()!r} of {dist.get_world_size()} ranks; "
            "a fake mesh needs a process of its own"
        )
    kind = torch.device(device).type
    key = (tuple(shape), tuple(axes), kind)
    if key not in _FAKE_MESHES:
        if kind == "cuda":
            torch.cuda.set_device(0)
        mesh = DeviceMesh(kind, torch.arange(base, base + n).view(tuple(shape)), mesh_dim_names=tuple(axes))
        for i, name in enumerate(axes):
            GROUP_AXES[mesh.get_group(i).group_name] = name
        _FAKE_MESHES[key] = mesh
    return _FAKE_MESHES[key]


def release_fake_meshes() -> None:
    """Forget every fake mesh and destroy the ``fake`` default group, if
    one was made: the process is free to hold other groups (a test's
    teardown; a dry-run worker keeps its group to its end).  Meshes made
    afterwards span the next block of ranks, so none equals an earlier one
    whose plans DTensor still caches: those name groups that are gone."""
    _FAKE_MESHES.clear()
    GROUP_AXES.clear()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
        if _BLOCK[0] + 1 == FAKE_BLOCKS:
            raise RuntimeError(f"the fake group was released {FAKE_BLOCKS} times; a process has no more blocks")
        _BLOCK[0] += 1


def make_production_mesh(*, multi_pod: bool = False, device: Union[str, torch.device] = "cpu"):
    """The production mesh (module docstring): (16, 16) over ``("data",
    "model")``, or (2, 16, 16) over ``("pod", "data", "model")`` with
    ``multi_pod``; rank 0's view, over the ``fake`` backend."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_fake_mesh((16, 16), ("data", "model"), device)
