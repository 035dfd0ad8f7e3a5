"""Synthetic datasets — the port's own copy of ``repro/data/synthetic.py``
(``make_image_dataset`` and its helpers, ``make_token_dataset``), verbatim,
so that the same seed gives byte-identical arrays.

MNIST / Fashion-MNIST are not available offline, so the paper's experiments
run on a *class-structured* synthetic image dataset with the same interface:
28×28×1 images, 10 classes, 60k samples, normalised to zero mean / unit-ish
variance (Assumption 1 asks for normalised inputs).

Each class j has a smooth random prototype field P_j; a sample is
``α·P_j + shift + texture-noise`` with per-sample jitter, so (i) classes are
separable by a small CNN but not trivially, (ii) per-class latent feature
distributions differ — which is exactly what FC-1 profiling must pick up.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticImageDataset", "make_image_dataset", "make_token_dataset"]


@dataclasses.dataclass
class SyntheticImageDataset:
    xs: np.ndarray  # (N, H, W, 1) float32, normalised
    ys: np.ndarray  # (N,) int32
    num_classes: int

    def subset(self, idx: np.ndarray) -> "SyntheticImageDataset":
        return SyntheticImageDataset(self.xs[idx], self.ys[idx], self.num_classes)


def _smooth_field(rng: np.random.Generator, h: int, w: int, passes: int = 3) -> np.ndarray:
    f = rng.normal(size=(h, w)).astype(np.float32)
    for _ in range(passes):  # box blur => smooth blob structure
        f = (
            f
            + np.roll(f, 1, 0)
            + np.roll(f, -1, 0)
            + np.roll(f, 1, 1)
            + np.roll(f, -1, 1)
        ) / 5.0
    f = (f - f.mean()) / (f.std() + 1e-8)
    return f


def make_image_dataset(
    n: int = 60_000,
    num_classes: int = 10,
    h: int = 28,
    w: int = 28,
    seed: int = 0,
    noise: float = 0.6,
    max_shift: int = 3,
) -> SyntheticImageDataset:
    """Class-conditional synthetic images, MNIST-like in shape and scale."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_field(rng, h, w) for _ in range(num_classes)])
    ys = rng.integers(0, num_classes, size=n).astype(np.int32)
    alpha = rng.uniform(0.7, 1.3, size=(n, 1, 1)).astype(np.float32)
    xs = protos[ys] * alpha
    # small random translations (classes stay separable, samples vary)
    sx = rng.integers(-max_shift, max_shift + 1, size=n)
    sy = rng.integers(-max_shift, max_shift + 1, size=n)
    for i in range(n):  # vectorised roll per unique shift would be overkill here
        if sx[i] or sy[i]:
            xs[i] = np.roll(xs[i], (sx[i], sy[i]), axis=(0, 1))
    xs = xs + noise * rng.normal(size=xs.shape).astype(np.float32)
    xs = (xs - xs.mean()) / (xs.std() + 1e-8)
    return SyntheticImageDataset(xs[..., None].astype(np.float32), ys, num_classes)


def make_token_dataset(
    n_docs: int = 2_000,
    doc_len: int = 256,
    vocab: int = 512,
    num_topics: int = 10,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Topic-conditional token documents: returns (docs (N, L) int32, topics (N,)).

    Each topic owns a sparse transition structure over a preferred token band,
    so language-model loss is topic-dependent — giving the LM-FL examples real
    non-IID structure.
    """
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, num_topics, size=n_docs).astype(np.int32)
    band = vocab // num_topics
    docs = np.zeros((n_docs, doc_len), np.int32)
    for t in range(num_topics):
        idx = np.nonzero(topics == t)[0]
        if idx.size == 0:
            continue
        lo = t * band
        # 80% in-band tokens with a deterministic drift, 20% uniform
        cur = rng.integers(lo, lo + band, size=idx.size)
        for pos in range(doc_len):
            docs[idx, pos] = cur
            drift = (cur + rng.integers(1, 4, size=idx.size) - lo) % band + lo
            uni = rng.integers(0, vocab, size=idx.size)
            use_band = rng.random(idx.size) < 0.8
            cur = np.where(use_band, drift, uni)
    return docs, topics
