"""Continuous-batching serving engine.

The JAX package's engine as PyTorch code that runs eagerly:

* :class:`DecodeState` holds everything a slot batch evolves: per-slot
  model caches (``init_caches(..., per_slot=True)``: KV caches, RWKV or
  RG-LRU states, every slot at its own depth), the last sampled token, the generated-token buffer, per-slot
  counters and budgets, the active and occupancy masks, and one sampling
  ``torch.Generator`` per slot.
* :func:`make_decode_fn` is one decode step for all slots: the model's
  ``decode_step`` (through K5 or K7 with ``use_flash``), per-slot
  sampling, stop handling and the masked token write.  Inactive slots run
  the model too, on token 0, with their tokens and counters masked; their
  caches keep advancing (a KV cache wraps, an RWKV or RG-LRU state takes
  the token in), and admission overwrites every row of the slot.  Idle
  slots also take MoE capacity, so they decide, as in JAX, which active
  tokens an expert drops.
* :func:`run_scan` and :func:`run_while` loop the step: a fixed count, or
  until every slot has stopped.
* :func:`make_admit_fn` prefills one queued sequence into a width-1
  per-slot cache and installs it in the first unoccupied slot.
* :class:`ServeEngine` is the host side: an admission queue, decode in
  chunks of ``decode_chunk`` steps, harvest of finished slots, refill,
  and, with a :class:`~repro_torch.obs.TelemetrySink`, the events of
  each submission, admission, decode chunk and finish.

**In place.**  The step and the admission write the caches, the token
buffer and the per-slot buffers of the state they are given in place (a
full-width cache is hundreds of MB; a copy per step would double it), and
return a state that shares them.  A state passed in is not to be used
again after the call.

**Static shapes.**  JAX's "one compiled program per entry point" becomes
fixed input shapes: every call of the decode chunk and of the admission
sees the same shapes and dtypes whatever the traffic.
:meth:`ServeEngine.compile_counts` counts the distinct input-shape
signatures each has seen, and continuous traffic must keep both at 1.
Run eagerly, the state's shapes are fixed when it is built, so the counts
stay 1 by construction; they count something real only once the decode
chunk is captured as a CUDA graph, which is left for a later change.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import tracing as obs_tracing_lib
from repro_torch.serve.sampling import sample_tokens, slot_noise

__all__ = [
    "ServeConfig",
    "DecodeState",
    "init_decode_state",
    "make_decode_fn",
    "make_admit_fn",
    "run_scan",
    "run_while",
    "Finished",
    "ServeEngine",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving knobs."""

    batch: int  # slot count B
    cache_len: int  # per-slot cache capacity (>= prompt + generation budget)
    max_new: int  # output buffer width (>= any per-slot budget)
    temperature: float = 0.0  # 0.0 = greedy
    eos_id: Optional[int] = None  # None = budget-only stopping
    use_flash: bool = False  # decode attention through K5, the RWKV time mix through K7
    decode_chunk: int = 8  # decode steps between admission checks

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch={self.batch} must be >= 1")
        if self.max_new < 1 or self.max_new > self.cache_len:
            raise ValueError(
                f"max_new={self.max_new} must be in [1, cache_len={self.cache_len}]"
            )
        if self.temperature < 0.0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk={self.decode_chunk} must be >= 1")


@dataclasses.dataclass
class DecodeState:
    """Everything a slot batch evolves.  Tensors lead with the slot axis B,
    except the caches, whose unit leaves lead with the layer stack."""

    caches: Dict  # per-slot model caches (pos: (B,))
    last_tok: torch.Tensor  # (B, 1) int32 next decode input
    out_tokens: torch.Tensor  # (B, max_new) int32 generated tokens
    n_gen: torch.Tensor  # (B,) int32 generated so far (incl. the prefill sample)
    gen_target: torch.Tensor  # (B,) int32 per-slot generation budget
    active: torch.Tensor  # (B,) bool slot is decoding
    seq_ids: torch.Tensor  # (B,) int32 sequence id; -1 = empty.  Occupancy: set
    # at admission, cleared only at harvest (a budget-1 admission or a stop
    # clears ``active`` before the host has the tokens)
    generators: List[torch.Generator]  # per-slot sampling streams
    step: int = 0  # decode steps taken


def _seed(host: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (), generator=host))


def _slot_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def init_decode_state(
    cfg: ModelConfig, scfg: ServeConfig, seed: int = 0, device=None
) -> DecodeState:
    """All slots empty; admission fills them.  Slot b's sampling stream is
    seeded from ``seed``."""
    device = resolve_device(device)
    b = scfg.batch
    host = torch.Generator().manual_seed(seed)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DecodeState(
        caches=T.init_caches(cfg, b, scfg.cache_len, per_slot=True, device=device),
        last_tok=zeros(b, 1),
        out_tokens=zeros(b, scfg.max_new),
        n_gen=zeros(b),
        gen_target=zeros(b),
        active=zeros(b, dtype=torch.bool),
        seq_ids=torch.full((b,), -1, dtype=torch.int32, device=device),
        generators=[_slot_generator(_seed(host), device) for _ in range(b)],
    )


# ------------------------------------------------------------- decode step


def make_decode_fn(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """One decode step for all slots: ``(params, state) -> state``, writing
    the caches and ``out_tokens`` in place.  Inactive slots' sampled tokens
    are pinned to 0 and their ``out_tokens``, ``n_gen`` and ``active`` do
    not change; their caches do, as in the JAX package: the model runs on
    every row, so an inactive slot's KV cache and position advance and its
    RWKV state takes token 0 in.  Admission overwrites all of it."""

    def decode_fn(params: Dict, state: DecodeState) -> DecodeState:
        logits, caches = T.decode_step(
            cfg, params, state.last_tok, state.caches, use_flash=scfg.use_flash
        )
        toks = sample_tokens(logits, scfg.temperature, slot_noise(logits, scfg.temperature, state.generators))
        toks = torch.where(state.active, toks, 0)

        # record into each slot's next free cell (masked; the clamp keeps the
        # write in bounds for exhausted slots)
        rows = torch.arange(toks.shape[0], device=toks.device)
        cell = state.n_gen.clamp(max=scfg.max_new - 1)
        cur = state.out_tokens[rows, cell]
        state.out_tokens[rows, cell] = torch.where(state.active, toks, cur)
        n_gen = state.n_gen + state.active.to(torch.int32)

        # per-slot stopping: budget reached, or EOS sampled
        active = state.active & (n_gen < state.gen_target)
        if scfg.eos_id is not None:
            active &= toks != scfg.eos_id
        return dataclasses.replace(
            state, caches=caches, last_tok=toks[:, None], n_gen=n_gen, active=active,
            step=state.step + 1,
        )

    return decode_fn


def run_scan(decode_fn: Callable, params: Dict, state: DecodeState, steps: int) -> DecodeState:
    """``steps`` decode steps (a fixed count)."""
    for _ in range(steps):
        state = decode_fn(params, state)
    return state


def run_while(decode_fn: Callable, params: Dict, state: DecodeState, max_steps: int) -> DecodeState:
    """Decode until every slot has stopped, or ``max_steps`` steps.  Reads
    the active mask on the host before each step."""
    limit = state.step + max_steps
    while state.step < limit and bool(state.active.any()):
        state = decode_fn(params, state)
    return state


# ----------------------------------------------------- slot-based admission


def _scatter_caches(dst: Dict, src: Dict, slot: int) -> None:
    """Copy every leaf of the width-1 caches ``src`` (k/v, an RWKV layer's
    tm_x/wkv/cm_x or an RG-LRU layer's conv/h, and pos) into row ``slot``
    of ``dst``: unit
    leaves are layer-stacked (reps, B, ...), so the batch is axis 1;
    remainder leaves lead with B."""
    for d, s in zip(dst["unit"], src["unit"]):
        for name in d:
            d[name][:, slot] = s[name][:, 0]
    for d, s in zip(dst["rem"], src["rem"]):
        for name in d:
            d[name][slot] = s[name][0]


def make_admit_fn(cfg: ModelConfig, scfg: ServeConfig, prompt_len: int) -> Callable:
    """Admission: prefill one queued sequence and install it in the first
    free slot, in place.

    ``(params, state, prompt (1, P), gen_target, seq_id, generator) ->
    state``.  The slot is the first of a stable sort of ``seq_ids >= 0``
    (empty first).  Free means unoccupied, not merely inactive: a budget-1
    admission finishes at prefill and stays occupied until the host
    harvests it, and a second admission in the same wave must not take its
    slot.  The prefill runs on a width-1 per-slot cache of the same
    ``cache_len`` (with ``use_flash``, an RWKV prefill goes through K7), so
    every cache row copies over as it is; the first token
    is sampled from the prefill logits with the sequence's own generator,
    which then becomes the slot's stream.
    """

    def admit_fn(
        params: Dict, state: DecodeState, prompt: torch.Tensor, gen_target: int,
        seq_id: int, generator: torch.Generator,
    ) -> DecodeState:
        occupied = (state.seq_ids >= 0).to(torch.int32)
        slot = int(torch.argsort(occupied, stable=True)[0])

        device = prompt.device
        caches1 = T.init_caches(cfg, 1, scfg.cache_len, per_slot=True, device=device)
        positions = T.mrope_streams(cfg, torch.arange(prompt_len, dtype=torch.int32, device=device)[None, :])
        hidden, caches1, _ = T.forward(cfg, params, prompt, positions, caches1, use_flash=scfg.use_flash)
        logits = T.logits_from_hidden(cfg, params, hidden[:, -1:])
        tok = sample_tokens(logits, scfg.temperature, slot_noise(logits, scfg.temperature, [generator]))

        _scatter_caches(state.caches, caches1, slot)
        state.last_tok[slot] = tok
        state.out_tokens[slot] = 0
        state.out_tokens[slot, :1] = tok
        state.n_gen[slot] = 1
        state.gen_target[slot] = gen_target
        if gen_target > 1:
            state.active[slot] = True
        state.seq_ids[slot] = seq_id
        state.generators[slot] = generator
        return state

    return admit_fn


# ------------------------------------------------------------- host engine


@dataclasses.dataclass
class Finished:
    seq_id: int
    tokens: np.ndarray  # (n_gen,) generated tokens (incl. the prefill sample)


def _signature(x: Any) -> Any:
    """Shapes and dtypes of the tensors in ``x`` (what would make a traced
    program recompile); Python scalars and generators carry none."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, DecodeState):
        return tuple(_signature(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return None


class _ShapeCounted:
    """Calls ``fn`` and records the shape signature of its arguments."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.signatures: Set[Any] = set()

    def __call__(self, *args):
        self.signatures.add(_signature(args[1:]))  # args[0] is the params
        return self.fn(*args)


class ServeEngine:
    """Host-side continuous batching: an admission queue, decode in chunks
    of ``scfg.decode_chunk`` steps, harvest of stopped slots and refill.
    Runs on the device of ``params``.

    ``telemetry`` (a :class:`~repro_torch.obs.TelemetrySink`) takes
    ``serve_submit``, ``serve_admit`` (with TTFT), ``serve_chunk`` and
    ``serve_finish`` events, emitted between the device's work at the
    queue's boundaries.  Without one the engine adds no synchronise and
    records no clock; with one it reads the generated counts around each
    chunk (two host reads a chunk) and nothing else changes: the same
    tokens, the same shape signatures."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Dict,
                 prompt_len: int, seed: int = 0, telemetry=None):
        if prompt_len < 1:
            raise ValueError(f"prompt_len={prompt_len} must be >= 1")
        if scfg.cache_len < prompt_len + scfg.max_new:
            # an undersized cache wraps its write index (pos % slots in
            # attention.py) and silently corrupts the oldest context
            raise ValueError(
                f"cache_len={scfg.cache_len} < prompt_len + max_new = "
                f"{prompt_len + scfg.max_new}; size the per-slot cache to "
                "hold the full prompt plus the generation budget"
            )
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.prompt_len = prompt_len
        self.device = params["embed"]["w"].device
        self._host = torch.Generator().manual_seed(seed)
        self.state = init_decode_state(cfg, scfg, _seed(self._host), self.device)
        decode_fn = make_decode_fn(cfg, scfg)
        self._chunk = _ShapeCounted(lambda p, s: run_scan(decode_fn, p, s, scfg.decode_chunk))
        self._admit = _ShapeCounted(make_admit_fn(cfg, scfg, prompt_len))
        self.finished: List[Finished] = []
        self._queue: List[Tuple[int, np.ndarray, int]] = []
        self._next_id = 0
        self._sink = telemetry
        self._t_submit: Dict[int, float] = {}
        self._pending_admits: List[Tuple[int, int]] = []  # (seq_id, queue depth)

    # -- queue ------------------------------------------------------------

    def submit(self, prompt: np.ndarray, gen_target: int) -> int:
        """Queue one prompt (``(prompt_len,)`` int tokens); returns its id."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.shape != (self.prompt_len,):
            raise ValueError(f"prompt must be ({self.prompt_len},), got {prompt.shape}")
        if not 1 <= gen_target <= self.scfg.max_new:
            raise ValueError(f"gen_target={gen_target} must be in [1, {self.scfg.max_new}]")
        seq_id = self._next_id
        self._next_id += 1
        self._queue.append((seq_id, prompt, gen_target))
        if self._sink is not None:
            self._t_submit[seq_id] = time.perf_counter()
            self._sink.emit("serve_submit", seq_id=seq_id, gen_target=gen_target, queue_depth=len(self._queue))
        return seq_id

    # -- engine steps ------------------------------------------------------

    def _refill(self) -> None:
        # free = unoccupied (seq_id < 0), not merely inactive: stopped slots
        # keep their seq_id until harvest and must not be admitted over
        free = int((self.state.seq_ids < 0).sum())
        for _ in range(min(free, len(self._queue))):
            seq_id, prompt, tgt = self._queue.pop(0)
            gen = _slot_generator(_seed(self._host), self.device)
            tokens = torch.as_tensor(prompt, device=self.device)[None]
            with obs_tracing_lib.annotate("serve.admit"):
                self.state = self._admit(self.params, self.state, tokens, tgt, seq_id, gen)
            if self._sink is not None:
                # TTFT is taken in _harvest, after its done-mask read, which
                # waits for the wave's prefills as the path without a sink
                # does: a read here would serialise the admissions
                self._pending_admits.append((seq_id, len(self._queue)))
        # budget-1 sequences finish at admission; harvest them like any
        # stopped slot
        self._harvest()

    def _harvest(self) -> None:
        """Collect slots that stopped (budget or EOS) and mark them free."""
        st = self.state
        done = (~st.active & (st.seq_ids >= 0) & (st.n_gen > 0)).cpu().numpy()
        if self._sink is not None and self._pending_admits:
            # the read above waited for the admitted sequences' first tokens
            now = time.perf_counter()
            occupancy = int((st.seq_ids >= 0).sum())
            for seq_id, depth in self._pending_admits:
                self._sink.emit(
                    "serve_admit", seq_id=seq_id, ttft_s=round(now - self._t_submit.get(seq_id, now), 6),
                    queue_depth=depth, occupancy=occupancy,
                )
            self._pending_admits = []
        if not done.any():
            return
        out = st.out_tokens.cpu().numpy()
        n_gen = st.n_gen.cpu().numpy()
        ids = st.seq_ids.cpu().numpy()
        for slot in np.nonzero(done)[0]:
            seq_id = int(ids[slot])
            self.finished.append(Finished(seq_id, out[slot, : int(n_gen[slot])].copy()))
            if self._sink is not None:
                now = time.perf_counter()
                self._sink.emit(
                    "serve_finish", seq_id=seq_id, n_tokens=int(n_gen[slot]),
                    latency_s=round(now - self._t_submit.pop(seq_id, now), 6),
                )
        mask = torch.as_tensor(done, device=self.device)
        self.state = dataclasses.replace(
            st, seq_ids=torch.where(mask, -1, st.seq_ids), n_gen=torch.where(mask, 0, st.n_gen)
        )

    def run(self, drain: bool = False) -> List[Finished]:
        """Drive queue and slots to completion; returns the finished
        sequences in completion order.  ``drain=True`` admits only when
        every slot is idle (drain-and-refill scheduling)."""
        self._maybe_refill(drain)
        while self._queue or bool(self.state.active.any()):
            if bool(self.state.active.any()):
                if self._sink is None:
                    with obs_tracing_lib.annotate("serve.decode_chunk"):
                        self.state = self._chunk(self.params, self.state)
                else:
                    self._timed_chunk()
            self._harvest()
            self._maybe_refill(drain)
        return self.finished

    def _timed_chunk(self) -> None:
        """One decode chunk and its ``serve_chunk`` event: the chunk's wall
        time up to the read of the generated counts after it, the tokens it
        generated, tok/s, active slots and queue depth.  Only with a sink:
        the reads wait for the device."""
        n_before, active = torch.stack([self.state.n_gen.sum(), self.state.active.sum()]).tolist()
        t0 = time.perf_counter()
        with obs_tracing_lib.annotate("serve.decode_chunk"):
            self.state = self._chunk(self.params, self.state)
        tokens = int(self.state.n_gen.sum()) - n_before
        dt = time.perf_counter() - t0
        self._sink.emit(
            "serve_chunk", steps=self.scfg.decode_chunk, tokens=tokens, dt_s=round(dt, 6),
            tok_s=round(tokens / max(dt, 1e-9), 1), active_slots=active, batch=self.scfg.batch,
            queue_depth=len(self._queue),
        )

    def _maybe_refill(self, drain: bool) -> None:
        if drain and bool(self.state.active.any()):
            self._harvest()
            return
        self._refill()

    def reset(self, seed: Optional[int] = None) -> None:
        """Fresh state, queue and results; the shape counts are kept."""
        if seed is not None:
            self._host = torch.Generator().manual_seed(seed)
        self.state = init_decode_state(self.cfg, self.scfg, _seed(self._host), self.device)
        self.finished = []
        self._queue = []
        self._next_id = 0
        self._t_submit = {}
        self._pending_admits = []

    # -- introspection -----------------------------------------------------

    def compile_counts(self) -> Dict[str, int]:
        """Distinct input-shape signatures seen by the decode chunk and the
        admission (the JAX engine's compiled-program counts).  In eager
        mode the state's shapes are fixed when it is built, so both counts
        stay 1 by construction; they become a real count once the decode
        chunk is captured as a CUDA graph."""
        return {"decode_chunk": len(self._chunk.signatures), "admit": len(self._admit.signatures)}
