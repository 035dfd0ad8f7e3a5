"""FLTrainer — Algorithm 1 (FL-DP³S) end-to-end, model-agnostic.

Simulates the full federation on one device: profiles every client once with
the freshly initialised global model (Alg. 1 lines 2-5), builds the eq.-(14)
kernel, then runs rounds: select cohort → local SGD on each cohort client
(eq. 3-5) → eq.-(6) aggregation.  Metrics: training-set accuracy (Fig. 1
protocol), GEMD per round (Fig. 2), last-known local losses.

:meth:`FLTrainer.run` packs the server's knowledge into a
:class:`~repro_torch.fl.engine.ServerState` and runs the rounds through the
engine (``fl/engine.py``) in segments between reprofile boundaries; at a
boundary it re-profiles, re-fits the clusters and, under the funnel, picks
new candidates with their kernel and cache.  :meth:`FLTrainer.run_legacy`
is the JAX package's host loop, kept as the engine's oracle: both loops
draw in the same order from one ``torch.Generator`` on the trainer's
device, seeded from ``cfg.seed``, so on one device they give the same
history bit for bit.

Works for any model exposing ``loss_fn(params, x, y)`` and
``feature_fn(params, x) -> (logits, feats)``; the paper's CNN is the default.
The Cluster baseline fingerprints clients by representative gradients.

With a client ``mesh`` (``launch/mesh.py``) a trainer is one rank's: each
rank builds one from the whole federation's arrays and keeps its C/D
resident clients on its device.  It profiles and scores its residents; the
(C, F) profiles the eq.-(14) kernel needs (or, under the funnel, the
losses for the prefilter and the (Q, F) candidate block) come from the
ranks through ``mesh.all_reduce`` at init and at each reprofile boundary,
and the rounds run through the engine's sharded round
(``engine.make_round_fn(mesh=)``), with the staleness ring restarted at
the current params each ``run`` call, as JAX's.  ``run_legacy`` is the
single-device loop and refuses a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import dpp as dpp_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import profiles as profiles_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core import similarity as similarity_lib
from repro_torch.device import resolve_device
from repro_torch.fl import engine as engine_lib
from repro_torch.fl import rounds as rounds_lib
from repro_torch.fl import scenarios as scenarios_lib
from repro_torch.fl import staleness as staleness_lib
from repro_torch.fl.engine import FLConfig
from repro_torch.obs import tracing as obs_tracing_lib
from repro_torch.tree import tree_map

__all__ = ["FLConfig", "FLTrainer"]


class FLTrainer:
    def __init__(
        self,
        cfg: FLConfig,
        params: Dict[str, torch.Tensor],
        loss_fn: Callable,
        feature_fn: Callable,
        client_xs: np.ndarray,  # (C, n_c, ...)
        client_ys: np.ndarray,  # (C, n_c)
        strategy: selection_lib.SelectionStrategy,
        eval_xs: Optional[np.ndarray] = None,
        eval_ys: Optional[np.ndarray] = None,
        accuracy_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
    ):
        """``device`` defaults to ``cuda`` (raising when there is none);
        pass ``device="cpu"`` to run on the CPU.  With ``mesh`` the trainer
        is that rank's and runs on the rank's device."""
        if client_xs.shape[0] != cfg.num_clients:
            raise ValueError(
                f"client_xs holds {client_xs.shape[0]} clients, cfg.num_clients="
                f"{cfg.num_clients}"
            )
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # this rank's residents [lo, hi) (the whole federation without a mesh)
        lo, hi = (0, cfg.num_clients) if mesh is None else mesh.residents(cfg.num_clients)
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.feature_fn = feature_fn
        self.strategy = strategy
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.client_xs = torch.as_tensor(client_xs[lo:hi], device=self.device)
        self.client_ys = torch.as_tensor(client_ys[lo:hi], device=self.device)
        all_ys = torch.as_tensor(client_ys, device=self.device)
        self.eval_xs = None if eval_xs is None else torch.as_tensor(eval_xs, device=self.device)
        self.eval_ys = None if eval_ys is None else torch.as_tensor(eval_ys, device=self.device)
        self.accuracy_fn = accuracy_fn
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # the scenario's draws and the funnel's predictions: streams of
        # their own, so neither moves a cohort (engine.salted_generator)
        self.env_generator = (
            None if cfg.scenario is None
            else engine_lib.salted_generator(cfg.seed, engine_lib._ENV_SALT, self.device)
        )
        self.funnel_generator = engine_lib.salted_generator(cfg.seed, engine_lib._FUNNEL_SALT, self.device)
        # the fault model's draws, kept across run calls as the scenario's
        self.fault_generator = engine_lib.fault_stream(cfg, self.device)
        self._round_fn_memo = None
        # k-DPP spectral cache, keyed on the kernel tensor it was built from;
        # _init_profiles (reprofile boundaries) invalidates it with the kernel
        self._eig_state = None
        self._eig_kernel = None

        n_c = client_xs.shape[1]
        self.client_sizes = torch.full((cfg.num_clients,), float(n_c), device=self.device)
        self.client_label_dists = torch.stack(
            [
                metrics_lib.label_distribution(self.client_ys[c], cfg.num_classes)
                for c in range(hi - lo)
            ]
        )
        self.global_label_dist = metrics_lib.label_distribution(
            all_ys.reshape(-1), cfg.num_classes
        )

        steps = engine_lib._steps_per_round(cfg, n_c)
        self._round_step = rounds_lib.build_client_parallel_round(
            lambda p, batch: loss_fn(p, batch[0], batch[1]), cfg.lr, steps,
            grad_clip=cfg.grad_clip,
        )

        self.history: Dict[str, List] = {"round": [], "acc": [], "gemd": [], "loss": []}
        self.round_state = selection_lib.RoundState(
            num_clients=cfg.num_clients, client_sizes=self.client_sizes
        )
        self._init_profiles()
        # initial last-known local losses (one global pass — the server can
        # get these from the initial broadcast in practice)
        self.losses = self._loss_of(self.client_xs, self.client_ys)
        self.round_state.losses = self.losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _loss_of(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """Per-client loss of the current params: (M, n_c, ...) -> (M,)."""
        return torch.stack([self.loss_fn(self.params, x, y) for x, y in zip(xs, ys)])

    def _all_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The (C, ...) tensor of every client's rows: ``rows`` itself
        without a mesh, else the ranks' residents' rows through one
        all-reduce (``ClientMesh.assemble``)."""
        return rows if self.mesh is None else self.mesh.assemble(rows, self.cfg.num_clients)

    def _init_profiles(self):
        """Alg. 1 lines 2-5: one-shot FC-1 profiling + kernel construction
        (on a mesh: the residents' profiles, the kernel over all of them)."""
        feats = profiles_lib.profile_all_clients(
            self.feature_fn, self.params, list(self.client_xs)
        )
        self.round_state.profiles = feats
        if self.cfg.candidate_frac is None:
            self.round_state.kernel = similarity_lib.kernel_from_profiles(
                self._all_rows(feats), use_kernel=self.cfg.use_pallas_kernel
            )
        else:
            # under the funnel the kernel lives on the candidate block, built
            # per segment by engine.funnel_fields: no C × C kernel here
            self.round_state.kernel = None
        # the spectral cache decomposes exactly this kernel — invalidate
        self._eig_state = None
        self._eig_kernel = None
        # representative-gradient fingerprints for the Cluster baseline, in
        # the parameter dict's own order and layouts (for the paper CNN,
        # FC-2's weight as (out, in): JAX's (in, out) transposed, the same
        # permutation for every client, which cosine clustering ignores)
        if isinstance(self.strategy, selection_lib.ClusterSelection):
            gp = [
                profiles_lib.representative_gradient_profile(
                    self.loss_fn, self.params, self.client_xs[c], self.client_ys[c]
                )
                for c in range(self.client_xs.shape[0])
            ]
            self.round_state.grad_profiles = self._all_rows(torch.stack(gp))

    def _cluster_labels(self, candidates: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Host-fitted cluster labels of the Cluster baseline (the fit is
        cached on the fingerprints' content, so only a reprofile
        re-clusters), on the funnel's candidate rows when ``candidates`` is
        given (at Q = C the unfunnelled labels); zeros for every other
        strategy."""
        if isinstance(self.strategy, selection_lib.ClusterSelection):
            return self.strategy.labels_for(self.round_state, self.cfg.clients_per_round, rows=candidates)
        n = self.cfg.num_clients if candidates is None else candidates.shape[0]
        return torch.zeros((n,), dtype=torch.int32, device=self.device)

    def _make_client_batches(self, sel: torch.Tensor):
        """Slice the selected clients' data into (C_p, steps, B, ...) batches."""
        return engine_lib.make_client_batches(
            self.cfg, self.generator, self.client_xs, self.client_ys, sel
        )

    def eig_state(self) -> dpp_lib.KDPPSamplerState:
        """Spectral cache of the current kernel (one eigh per kernel refresh).

        Memoised on the kernel tensor's identity; ``_init_profiles`` (every
        ``reprofile_every`` boundary) drops the memo together with the kernel
        it decomposed.  Strategies that never draw from the cache get the
        cheap identity-layout placeholder instead of an O(C³) eigh.
        """
        kern = self.round_state.kernel
        if self._eig_state is None or self._eig_kernel is not kern:
            k = self.cfg.clients_per_round
            if getattr(self.strategy, "uses_spectral_cache", False):
                self._eig_state = dpp_lib.kdpp_sampler_state(kern, k)
            else:
                self._eig_state = dpp_lib.identity_sampler_state(
                    self.cfg.num_clients, k, self.device
                )
            self._eig_kernel = kern
        return self._eig_state

    def selection_state(self) -> selection_lib.SelectionState:
        """The server's current knowledge as a draw's input, with the
        memoised spectral cache and the cluster labels."""
        rs = self.round_state
        return selection_lib.selection_state(
            self.cfg.num_clients, self.cfg.clients_per_round, kernel=rs.kernel,
            losses=rs.losses, client_sizes=rs.client_sizes,
            cluster_labels=self._cluster_labels(), eig_state=self.eig_state(),
        )

    # ------------------------------------------------------------------
    def _supports_engine(self) -> bool:
        """A strategy runs through the engine when it overrides ``draw_fn``;
        one that does not falls back to the legacy loop."""
        return type(self.strategy).draw_fn is not selection_lib.SelectionStrategy.draw_fn

    def _selection_fields(self) -> Dict:
        """The ServerState fields the profiles decide: the profiles, the
        kernel with its cache, the cluster labels and, under the funnel, a
        new candidate set on the current losses (predicted for the current
        round) with its (Q, Q) kernel and cache."""
        rs = self.round_state
        if self.cfg.candidate_frac is None:
            cand, kern, eig = None, rs.kernel, self.eig_state()
        else:
            cand, kern, eig = engine_lib.funnel_fields(
                self.cfg, self.funnel_generator, rs.profiles, self._all_rows(self.losses),
                strategy=self.strategy, round_index=rs.round, mesh=self.mesh,
            )
        return dict(profiles=rs.profiles, kernel=kern, eig_state=eig,
                    cluster_labels=self._cluster_labels(cand), candidates=cand)

    def server_state(self) -> engine_lib.ServerState:
        """The trainer's current server knowledge as a ServerState, sharing
        the trainer's generators; a guarded config's quarantine counters and
        a stateful algorithm's per-client state start at zero (as JAX's:
        they carry across the reprofile segments of one ``run`` call).  On a
        mesh, the rank's state; a staleness config's ring starts with every
        slot at the current params and its counters at 0, each ``run``
        call opening on a synced federation (as JAX's)."""
        cfg = self.cfg
        rob = engine_lib.robustness_fields(cfg, self.params, cfg.num_clients, self.device, self.fault_generator)
        extra = {}
        if self.mesh is not None:
            lo, hi = self.mesh.residents(cfg.num_clients)
            if rob["algo_state"] is not None:
                rob["algo_state"] = tree_map(lambda x: x[lo:hi], rob["algo_state"])
            extra.update(shard_rank=self.mesh.rank, shard_count=self.mesh.size)
        if cfg.staleness_bound is not None:
            extra["param_hist"], extra["shard_staleness"] = staleness_lib.init_staleness_fields(
                self.params, cfg.staleness_bound, self.mesh
            )
        return engine_lib.ServerState(
            params=self.params,
            generator=self.generator,
            round=self.round_state.round,
            losses=self.losses,
            client_xs=self.client_xs,
            client_ys=self.client_ys,
            client_sizes=self.client_sizes,
            client_label_dists=self.client_label_dists,
            global_label_dist=self.global_label_dist,
            env_generator=self.env_generator,
            **rob,
            **self._selection_fields(),
            **extra,
        )

    def round_fn(self):
        """The engine's per-round transition for this trainer (memoised)."""
        if self._round_fn_memo is None:
            self._round_fn_memo = engine_lib.make_round_fn(
                self.cfg, self.loss_fn, (self.strategy,), accuracy_fn=self.accuracy_fn,
                eval_data=None if self.eval_xs is None else (self.eval_xs, self.eval_ys),
                mesh=self.mesh,
            )
        return self._round_fn_memo

    def _absorb(self, state: engine_lib.ServerState):
        """Pull a segment's final state back into the trainer's fields."""
        self.params = state.params
        self.losses = state.losses
        self.round_state.losses = self.losses
        self.round_state.round = state.round
        self.fault_generator = state.fault_generator

    # ------------------------------------------------------------------
    def run(self, rounds: Optional[int] = None, progress: bool = False, sink=None) -> Dict[str, List]:
        """Run rounds through the engine, in segments that end at the
        multiples of ``reprofile_every``; after each such boundary the
        trainer re-profiles every client, re-fits the clusters and, under
        the funnel, re-funnels.  (JAX's ``run`` skips a boundary that ends
        the run; here every multiple re-profiles, as the legacy loop does,
        so the two loops leave the same state for a later call.)  History
        as the legacy loop records it: every ``eval_every`` rounds and the
        last round, whose accuracy is evaluated here when it is off the
        grid.  Round numbers continue from earlier ``run`` calls.  A
        strategy that does not override ``draw_fn`` runs the legacy loop,
        which refuses faults, robust aggregation and a local algorithm other
        than FedAvg.

        ``sink`` (an :class:`~repro_torch.obs.TelemetrySink`) takes each
        segment's rounds after the segment, and an ``fl_reprofile`` event
        at each boundary the next segment starts from (JAX's events for a
        run from round 0: none at a boundary that ends the run).  The
        legacy loop has no telemetry, so a sink there is a ``ValueError``."""
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        if not self._supports_engine():
            if sink is not None:
                raise ValueError(
                    f"a telemetry sink needs the engine: strategy {self.strategy.name!r} runs the legacy "
                    "loop (it does not override draw_fn), which has no telemetry"
                )
            return self.run_legacy(rounds=rounds, progress=progress)
        round_fn = self.round_fn()
        start = self.round_state.round
        end = start + rounds
        every = cfg.reprofile_every
        state = self.server_state()
        outs: List[Dict] = []
        t = start
        while t < end:
            n = end - t if not every else min(end - t, every - t % every)
            state, seg = engine_lib.run_scanned(round_fn, state, n, sink=sink)
            outs.append(seg)
            t += n
            self._absorb(state)
            if every and t % every == 0:
                with obs_tracing_lib.annotate("fl.reprofile"):
                    self._init_profiles()  # re-profile and re-fit the clusters
                if t < end:
                    if sink is not None:
                        sink.emit("fl_reprofile", round=t, funneled=cfg.candidate_frac is not None)
                    state = dataclasses.replace(state, **self._selection_fields())
        merged = engine_lib.concat_outputs(outs)
        final_acc = self._evaluate() if end % cfg.eval_every != 0 else None
        hist = engine_lib.history_from_outputs(merged, cfg.eval_every, final_acc=final_acc)
        for name in self.history:
            self.history[name].extend(hist[name])
        if progress:
            for r, a, g, l in zip(hist["round"], hist["acc"], hist["gemd"], hist["loss"]):
                print(f"[{self.strategy.name}] round {r:4d} acc={a:.4f} gemd={g:.3f} loss={l:.4f}")
        return self.history

    def run_legacy(self, rounds: Optional[int] = None, progress: bool = False) -> Dict[str, List]:
        """The host loop: per round, select on the device, run the cohort's
        local updates, aggregate, refresh the cohort's losses and the GEMD,
        re-profile every ``reprofile_every`` rounds, and evaluate every
        ``eval_every`` rounds and at the last round.  Round numbers continue
        from earlier calls.  The engine's oracle, and the loop of a strategy
        that overrides only ``select``.  It draws no scenario and runs no
        funnel, so it refuses a funnel and an availability model; it has no
        update guard and runs plain SGD, so it refuses faults, robust
        aggregation and any other local algorithm (JAX's ``run`` messages)."""
        cfg = self.cfg
        if self.mesh is not None:
            raise ValueError(
                "the legacy loop runs on one device: build the trainer without a mesh, or use run()"
            )
        if cfg.candidate_frac is not None:
            raise ValueError("candidate_frac needs the engine (FLTrainer.run): the legacy loop has no funnel")
        if cfg.guarded():
            raise ValueError(
                "faults / robust aggregation require a strategy with a pure select_fn (the "
                "scanned engine path): the legacy host loop has no fault-injection or quarantine layer"
            )
        if cfg.local_algo != "fedavg":
            raise ValueError(
                f"local_algo={cfg.local_algo!r} requires a strategy with a pure draw_fn (the scanned "
                "engine path): the legacy host loop is hardwired to plain SGD (fedavg)"
            )
        if cfg.scenario is not None and scenarios_lib.get_scenario(cfg.scenario).availability is not None:
            raise ValueError(
                f"scenario {cfg.scenario!r} masks availability, which only the engine "
                "(FLTrainer.run) draws"
            )
        rounds = rounds or cfg.rounds
        start = self.round_state.round
        for t in range(start + 1, start + rounds + 1):
            self.round_state.round = t
            if self._supports_engine():
                sel = self.strategy.draw_fn(self.generator, self.selection_state(), cfg.clients_per_round)
            else:  # a host-side strategy: its own select on the round state
                sel = self.strategy.select(self.generator, self.round_state, cfg.clients_per_round)
            sel = sel.long()
            batches = self._make_client_batches(sel)
            weights = self.client_sizes[sel]
            self.params, mean_loss = self._round_step(self.params, batches, weights)

            # refresh last-known losses for the selected clients
            sel_losses = self._loss_of(self.client_xs[sel], self.client_ys[sel])
            self.losses = self.losses.index_put((sel,), sel_losses)
            self.round_state.losses = self.losses

            g = metrics_lib.gemd(
                self.client_label_dists, self.client_sizes, sel, self.global_label_dist
            )
            if cfg.reprofile_every and t % cfg.reprofile_every == 0:
                self._init_profiles()

            if t % cfg.eval_every == 0 or t == start + rounds:
                acc = self._evaluate()
                self.history["round"].append(t)
                self.history["acc"].append(float(acc))
                self.history["gemd"].append(float(g))
                self.history["loss"].append(float(mean_loss))
                if progress:
                    print(
                        f"[{self.strategy.name}] round {t:4d} acc={float(acc):.4f} "
                        f"gemd={float(g):.3f} loss={float(mean_loss):.4f}"
                    )
        return self.history

    def _evaluate(self) -> float:
        if self.accuracy_fn is None:
            return float("nan")
        if self.eval_xs is not None:
            return self.accuracy_fn(self.params, self.eval_xs, self.eval_ys)
        # Fig.-1 protocol: accuracy of the global model on the training set
        xs = self.client_xs.reshape((-1,) + self.client_xs.shape[2:])
        ys = self.client_ys.reshape(-1)
        acc = self.accuracy_fn(self.params, xs, ys)
        if self.mesh is None:
            return acc
        # every rank's residents, each share weighed by its samples
        n = float(ys.numel())
        tot, cnt = self.mesh.all_reduce(torch.tensor([float(acc) * n, n], device=self.device))
        return float(tot / cnt)
