"""FLTrainer — Algorithm 1 (FL-DP³S) end-to-end, model-agnostic.

Simulates the full federation on one device: profiles every client once with
the freshly initialised global model (Alg. 1 lines 2-5), builds the eq.-(14)
kernel, then runs rounds in a host loop: select cohort → local SGD on each
cohort client (eq. 3-5) → eq.-(6) aggregation.  Metrics: training-set
accuracy (Fig. 1 protocol), GEMD per round (Fig. 2), last-known local losses.

The round loop is the JAX package's ``FLTrainer.run_legacy``; its scanned
engine is ``fl/engine.py``'s ``make_round_fn``.  Randomness comes from one
``torch.Generator`` on the trainer's device, seeded from ``cfg.seed``.

Works for any model exposing ``loss_fn(params, x, y)`` and
``feature_fn(params, x) -> (logits, feats)``; the paper's CNN is the default.
The Cluster baseline fingerprints clients by representative gradients.
"""

from __future__ import annotations

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
from repro_torch.fl.engine import FLConfig

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
    ):
        """``device`` defaults to ``cuda`` (raising when there is none);
        pass ``device="cpu"`` to run on the CPU."""
        if client_xs.shape[0] != cfg.num_clients:
            raise ValueError(
                f"client_xs holds {client_xs.shape[0]} clients, cfg.num_clients="
                f"{cfg.num_clients}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.feature_fn = feature_fn
        self.strategy = strategy
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.client_xs = torch.as_tensor(client_xs, device=self.device)
        self.client_ys = torch.as_tensor(client_ys, device=self.device)
        self.eval_xs = None if eval_xs is None else torch.as_tensor(eval_xs, device=self.device)
        self.eval_ys = None if eval_ys is None else torch.as_tensor(eval_ys, device=self.device)
        self.accuracy_fn = accuracy_fn
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # k-DPP spectral cache, keyed on the kernel tensor it was built from;
        # _init_profiles (reprofile boundaries) invalidates it with the kernel
        self._eig_state = None
        self._eig_kernel = None

        n_c = client_xs.shape[1]
        self.client_sizes = torch.full((cfg.num_clients,), float(n_c), device=self.device)
        self.client_label_dists = torch.stack(
            [
                metrics_lib.label_distribution(self.client_ys[c], cfg.num_classes)
                for c in range(cfg.num_clients)
            ]
        )
        self.global_label_dist = metrics_lib.label_distribution(
            self.client_ys.reshape(-1), cfg.num_classes
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

    def _init_profiles(self):
        """Alg. 1 lines 2-5: one-shot FC-1 profiling + kernel construction."""
        feats = profiles_lib.profile_all_clients(
            self.feature_fn, self.params, list(self.client_xs)
        )
        self.round_state.profiles = feats
        self.round_state.kernel = similarity_lib.kernel_from_profiles(
            feats, use_kernel=self.cfg.use_pallas_kernel
        )
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
                for c in range(self.cfg.num_clients)
            ]
            self.round_state.grad_profiles = torch.stack(gp)

    def _cluster_labels(self) -> torch.Tensor:
        """Host-fitted cluster labels of the Cluster baseline (the fit is
        cached on the fingerprints' content, so only a reprofile
        re-clusters); zeros for every other strategy."""
        if isinstance(self.strategy, selection_lib.ClusterSelection):
            return self.strategy.labels_for(self.round_state, self.cfg.clients_per_round)
        return torch.zeros((self.cfg.num_clients,), dtype=torch.int32, device=self.device)

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
    def run(self, rounds: Optional[int] = None, progress: bool = False) -> Dict[str, List]:
        """The host loop: per round, select on the device, run the cohort's
        local updates, aggregate, refresh the cohort's losses and the GEMD,
        re-profile every ``reprofile_every`` rounds, and evaluate every
        ``eval_every`` rounds and at the last round.  Round numbers continue
        from earlier ``run`` calls."""
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        start = self.round_state.round
        for t in range(start + 1, start + rounds + 1):
            self.round_state.round = t
            sel = self.strategy.draw_fn(
                self.generator, self.selection_state(), cfg.clients_per_round
            ).long()
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
        return self.accuracy_fn(self.params, xs, ys)
