"""Abstract dataset layer (copy of ``repro/data/datasets.py``).

Mirrors DeepSpeed-Chat's ``PromptRawDataset``: every source exposes prompts,
chosen and rejected responses; the blender unifies formats downstream.

The synthetic tasks are *learnable*: the chosen response is a deterministic
function of the prompt (copy / sort / constant-token), the rejected one is
noise — so the SFT loss goes down, the reward model reaches high pairwise
accuracy, and PPO measurably lifts reward.  Three distinct sources exist
specifically to exercise the paper's multi-dataset blending feature.
"""
from __future__ import annotations

import numpy as np


class PromptDataset:
    """Base interface: deterministic, indexable, seeded."""

    name = "abstract"

    def __init__(self, size: int, prompt_len: int, response_len: int,
                 vocab: int, seed: int = 0):
        self.size = size
        self.prompt_len = prompt_len
        self.response_len = response_len
        self.vocab = vocab
        self.seed = seed

    def __len__(self):
        return self.size

    def _rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng((self.seed * 1_000_003 + i) & 0x7FFFFFFF)

    def get_prompt(self, i: int) -> np.ndarray:
        return self._rng(i).integers(0, self.vocab, self.prompt_len,
                                     dtype=np.int32)

    def get_chosen(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def get_rejected(self, i: int) -> np.ndarray:
        rng = self._rng(i + 777_000_000)
        return rng.integers(0, self.vocab, self.response_len, dtype=np.int32)

    # reward oracle used by tests/benchmarks: how "chosen-like" a response is
    def score(self, prompt: np.ndarray, response: np.ndarray) -> float:
        gold = self.get_chosen_for(prompt)
        n = min(len(gold), len(response))
        return float((response[:n] == gold[:n]).mean()) if n else 0.0

    def get_chosen_for(self, prompt: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class CopyTaskDataset(PromptDataset):
    """Chosen response repeats the prompt."""
    name = "synthetic/copy"

    def get_chosen_for(self, prompt):
        reps = -(-self.response_len // len(prompt))
        return np.tile(prompt, reps)[:self.response_len]

    def get_chosen(self, i):
        return self.get_chosen_for(self.get_prompt(i))


class SortTaskDataset(PromptDataset):
    """Chosen response is the sorted prompt."""
    name = "synthetic/sort"

    def get_chosen_for(self, prompt):
        s = np.sort(prompt)
        reps = -(-self.response_len // len(s))
        return np.tile(s, reps)[:self.response_len].astype(np.int32)

    def get_chosen(self, i):
        return self.get_chosen_for(self.get_prompt(i))


class ConstantTaskDataset(PromptDataset):
    """Chosen response repeats the prompt's first token (easiest task)."""
    name = "synthetic/constant"

    def get_chosen_for(self, prompt):
        return np.full(self.response_len, prompt[0], np.int32)

    def get_chosen(self, i):
        return self.get_chosen_for(self.get_prompt(i))


SYNTHETIC_DATASETS = {
    "synthetic/copy": CopyTaskDataset,
    "synthetic/sort": SortTaskDataset,
    "synthetic/constant": ConstantTaskDataset,
}
