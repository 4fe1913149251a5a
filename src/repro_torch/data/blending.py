"""Data blending + per-stage splitting (DeepSpeed-Chat's "data abstraction
and blending capabilities"); copy of ``repro/data/blending.py``, so the same
seed gives the same batches, bit for bit.

``stage_split`` partitions each dataset's index space across the three
training stages (e.g. "2,4,4" weights, as in DS-Chat's ``--data_split``),
so no example leaks between stages.  ``DataBlender`` interleaves multiple
datasets with given proportions and emits fixed-shape numpy batches for:

- stage 1 (SFT):      tokens / labels / mask over prompt+chosen
- stage 2 (RM):       chosen vs rejected pairs
- stage 3 (PPO):      prompts only
- mixture training:   unsupervised LM batches (pretrain objective)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.datasets import PromptDataset


def stage_split(n: int, weights: Sequence[float]) -> List[np.ndarray]:
    """Split ``range(n)`` into len(weights) disjoint contiguous chunks with
    sizes proportional to ``weights``."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    bounds = np.floor(np.cumsum(w) * n).astype(int)
    out, lo = [], 0
    for hi in bounds:
        out.append(np.arange(lo, hi))
        lo = hi
    out[-1] = np.arange(out[-1][0] if len(out[-1]) else lo, n)
    return out


class DataBlender:
    def __init__(self, datasets: Sequence[PromptDataset],
                 proportions: Sequence[float] | None = None,
                 split_weights: Sequence[float] = (2, 4, 4),
                 seed: int = 0):
        self.datasets = list(datasets)
        p = np.asarray(proportions if proportions is not None
                       else [1.0] * len(datasets), np.float64)
        self.proportions = p / p.sum()
        self.seed = seed
        # disjoint per-stage index pools per dataset
        self.splits = [stage_split(len(d), split_weights)
                       for d in self.datasets]

    # -------------------------------------------------------------- #
    def _draw(self, rng, stage: int):
        ds_i = rng.choice(len(self.datasets), p=self.proportions)
        pool = self.splits[ds_i][stage]
        idx = int(pool[rng.integers(len(pool))])
        return self.datasets[ds_i], idx, ds_i

    def _skip(self, rng, stage: int, batch_size: int, skip: int):
        """Fast-forward a batch stream's RNG past ``skip`` batches.

        Each emitted batch consumes exactly ``batch_size`` draws, so
        replaying the draws (without materializing examples) leaves the
        generator bit-identical to one that actually yielded them — the
        data-cursor half of elastic resume (docs/checkpointing.md)."""
        for _ in range(skip * batch_size):
            self._draw(rng, stage)

    @staticmethod
    def _lm_example(ds: PromptDataset, idx: int):
        prompt = ds.get_prompt(idx)
        chosen = ds.get_chosen(idx)
        toks = np.concatenate([prompt, chosen])
        labels = np.concatenate([toks[1:], toks[-1:]])
        mask = np.zeros_like(toks, np.float32)
        mask[len(prompt) - 1:-1] = 1.0       # predict response tokens only
        return toks, labels, mask

    def sft_batches(self, batch_size: int, n_batches: int, stage: int = 0,
                    skip: int = 0):
        rng = np.random.default_rng(self.seed + 100)
        self._skip(rng, stage, batch_size, skip)
        for _ in range(n_batches - skip):
            toks, labs, masks = [], [], []
            for _ in range(batch_size):
                ds, idx, _ = self._draw(rng, stage)
                t, l, m = self._lm_example(ds, idx)
                toks.append(t), labs.append(l), masks.append(m)
            yield {"tokens": np.stack(toks), "labels": np.stack(labs),
                   "mask": np.stack(masks)}

    def reward_batches(self, batch_size: int, n_batches: int,
                       stage: int = 1, skip: int = 0):
        rng = np.random.default_rng(self.seed + 200)
        self._skip(rng, stage, batch_size, skip)
        for _ in range(n_batches - skip):
            ch, rj = [], []
            for _ in range(batch_size):
                ds, idx, _ = self._draw(rng, stage)
                prompt = ds.get_prompt(idx)
                ch.append(np.concatenate([prompt, ds.get_chosen(idx)]))
                rj.append(np.concatenate([prompt, ds.get_rejected(idx)]))
            ch, rj = np.stack(ch), np.stack(rj)
            ones = np.ones(ch.shape, np.float32)
            yield {"chosen": ch, "rejected": rj,
                   "chosen_mask": ones, "rejected_mask": ones.copy()}

    def prompt_batches(self, batch_size: int, n_batches: int,
                       stage: int = 2, skip: int = 0):
        rng = np.random.default_rng(self.seed + 300)
        self._skip(rng, stage, batch_size, skip)
        for _ in range(n_batches - skip):
            ps, oracle = [], []
            for _ in range(batch_size):
                ds, idx, ds_i = self._draw(rng, stage)
                ps.append(ds.get_prompt(idx))
                oracle.append(ds_i)
            yield {"prompts": np.stack(ps),
                   "dataset_idx": np.asarray(oracle, np.int32)}

    def pretrain_batches(self, batch_size: int, n_batches: int,
                         skip: int = 0):
        """Unsupervised batches for mixture (ptx) training."""
        rng = np.random.default_rng(self.seed + 400)
        self._skip(rng, 0, batch_size, skip)
        for _ in range(n_batches - skip):
            toks = []
            for _ in range(batch_size):
                ds, idx, _ = self._draw(rng, 0)
                t, _, _ = self._lm_example(ds, idx)
                toks.append(t)
            toks = np.stack(toks)
            labels = np.concatenate([toks[:, 1:], toks[:, -1:]], 1)
            yield {"tokens": toks, "labels": labels,
                   "mask": np.ones_like(toks, np.float32)}
