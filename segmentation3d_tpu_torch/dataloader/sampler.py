"""Epoch-concatenating index sampler.

The port of ``segmentation3d_tpu/dataloader/sampler.py``: the index stream
concatenates ``epochs`` shuffled permutations of the dataset range, each
drawn with ``np.random.default_rng(seed).permutation``, so one iteration
drives the whole run; ``len(sampler) == len(dataset) * epochs``.
"""
from __future__ import annotations

import numpy as np


class EpochConcateSampler:
    def __init__(self, dataset_len: int, epochs: int, seed: int = 0):
        self.dataset_len = int(dataset_len)
        self.epochs = int(epochs)
        self.seed = int(seed)

    def __len__(self):
        return self.dataset_len * self.epochs

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.epochs):
            yield from rng.permutation(self.dataset_len).tolist()
