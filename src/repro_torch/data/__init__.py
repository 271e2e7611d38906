"""Data pipeline: deterministic synthetic datasets + sharded host loading.

CIFAR-10/100/TinyImageNet are not available offline, so the image pipeline
generates *class-conditional* synthetic images (fixed per-class pattern +
noise) with the exact shapes/cardinalities of the real datasets — learnable,
deterministic, and dependency-free (DESIGN §7).  The token pipeline emits a
second-order Markov stream so LM training loss demonstrably decreases.

All loaders are process-sharded: ``host_slice`` cuts the global batch by an
explicit (rank, world size).

Copied from the JAX package's ``repro/data`` so that both packages make the
same images and tokens from a seed; numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


def host_slice(global_batch: int, process_index: int = 0,
               process_count: int = 1):
    """This process's slice of a global batch.  Rank and world size are
    explicit arguments: nothing on the host tells a program of a cluster."""
    pi, pc = process_index, process_count
    assert global_batch % pc == 0, (global_batch, pc)
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


# ------------------------------------------------------------ images


@dataclasses.dataclass(frozen=True)
class ImageDatasetCfg:
    n_classes: int = 10
    image_size: int = 32
    n_train: int = 2048            # synthetic stand-in sizes (fast CPU loops)
    n_test: int = 512
    noise: float = 0.35
    seed: int = 0

    @staticmethod
    def cifar10(**kw):
        return ImageDatasetCfg(n_classes=10, image_size=32, **kw)

    @staticmethod
    def cifar100(**kw):
        return ImageDatasetCfg(n_classes=100, image_size=32, **kw)

    @staticmethod
    def tiny_imagenet(**kw):
        return ImageDatasetCfg(n_classes=200, image_size=64, **kw)


class SyntheticImages:
    """Class-conditional synthetic images: per-class low-frequency pattern
    + per-sample noise.  Deterministic in (cfg.seed, split)."""

    def __init__(self, cfg: ImageDatasetCfg):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        s = cfg.image_size
        # per-class pattern: smooth random field (sum of a few sinusoids)
        xx, yy = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s))
        pats = []
        for c in range(cfg.n_classes):
            f = rng.uniform(1, 4, size=(3, 2))
            ph = rng.uniform(0, 2 * np.pi, size=(3, 2))
            a = rng.normal(size=(3,))
            pat = sum(a[i] * np.sin(2 * np.pi * (f[i, 0] * xx + f[i, 1] * yy)
                                    + ph[i, 0]) for i in range(3))
            pats.append(np.stack([pat, np.roll(pat, s // 3, 0),
                                  np.roll(pat, s // 3, 1)], -1))
        self.patterns = np.stack(pats).astype(np.float32)  # (C, s, s, 3)
        self.train = self._split(cfg.n_train, 1)
        self.test = self._split(cfg.n_test, 2)

    def _split(self, n, salt):
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1000 + salt)
        labels = rng.integers(0, cfg.n_classes, size=n)
        imgs = self.patterns[labels] + \
            rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)
                       ).astype(np.float32) * cfg.noise
        return imgs.astype(np.float32), labels.astype(np.int32)

    def batches(self, split: str, batch: int, seed: int = 0):
        """step -> dict(images, labels); deterministic per step."""
        imgs, labels = self.train if split == "train" else self.test
        n = len(labels)

        def get(step: int) -> Dict[str, np.ndarray]:
            rng = np.random.default_rng(seed * 100003 + step)
            idx = rng.integers(0, n, size=batch)
            return {"images": imgs[idx], "labels": labels[idx]}
        return get

    def eval_set(self, max_n: int = 512):
        imgs, labels = self.test
        return {"images": imgs[:max_n], "labels": labels[:max_n]}

    def train_eval_set(self, max_n: int = 512):
        """The paper evaluates BCD candidates on D_train (a fixed subsample
        here — DESIGN §7)."""
        imgs, labels = self.train
        return {"images": imgs[:max_n], "labels": labels[:max_n]}


# ------------------------------------------------------------ tokens


class MarkovTokens:
    """Second-order Markov token stream (learnable synthetic LM data)."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = min(branching, vocab)
        # each (prev token) maps to a small set of likely successors
        self.table = rng.integers(0, vocab, size=(vocab, self.branching))

    def batch(self, batch: int, seq: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(step * 7919 + 13)
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            choice = rng.integers(0, self.branching, size=batch)
            nxt = self.table[toks[:, t], choice]
            flip = rng.random(batch) < 0.05      # 5% noise
            nxt = np.where(flip, rng.integers(0, self.vocab, batch), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
