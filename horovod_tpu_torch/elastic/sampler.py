"""ElasticSampler: the port's copy of the JAX package's
``horovod_tpu/torch/elastic/sampler.py`` (Horovod's
``torch/elastic/sampler.py:24``): a rank-sharded sampler that reshards the
*unprocessed* indices when the world changes."""

from __future__ import annotations

import math
import random

import torch.utils.data

from horovod_tpu_torch.common.basics import process_rank, process_size


class ElasticSampler(torch.utils.data.Sampler):
    """Shards ``dataset`` over processes, records which indices were
    processed, and on ``reset()`` (after a rescale) re-shards only the
    remaining indices so no sample is dropped or repeated within an epoch.

    The order is the JAX package's: the remaining indices in ascending
    order, shuffled by ``random.Random(seed + epoch)``, padded by wrapping
    around to a multiple of the world size, and dealt out rank by rank::

        sampler = hvt.elastic.ElasticSampler(dataset)
        loader = DataLoader(dataset, sampler=sampler, ...)
        state = hvt.elastic.TorchState(model=..., sampler=sampler)
        for batch_idx, batch in enumerate(loader):
            ...
            sampler.record_batch(batch_idx, batch_size)
            state.commit()
    """

    def __init__(self, dataset, shuffle=True, seed=0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices = set()

        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def set_epoch(self, epoch):
        """New epoch: clear the processed set and reshuffle."""
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx, batch_size):
        """Mark the indices of this rank's batch ``batch_idx`` processed."""
        self.record_indices(self.get_indices(batch_idx, batch_size))

    def record_indices(self, indices):
        self.processed_indices.update(indices)

    def get_indices(self, batch_idx, batch_size):
        begin = batch_idx * batch_size
        end = min(begin + batch_size, len(self.indices))
        return self.indices[begin:end]

    def reset(self):
        """Re-shard the not-yet-processed indices over the current world."""
        self.num_replicas = process_size()
        self.rank = process_rank()

        remaining = [idx for idx in range(len(self.dataset))
                     if idx not in self.processed_indices]
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(remaining)
        self.remaining_indices = remaining

        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

        padded = list(self.remaining_indices)
        if padded:
            while len(padded) < self.total_size:
                padded += padded[:self.total_size - len(padded)]
        self.indices = padded[self.rank:self.total_size:self.num_replicas]

    def __iter__(self):
        self.reset()
        return iter(self.indices)

    def __len__(self):
        return self.num_samples

    def state_dict(self):
        return {
            "epoch": self.epoch,
            "processed_indices": sorted(self.processed_indices),
        }

    def load_state_dict(self, state_dict):
        self.epoch = state_dict["epoch"]
        self.processed_indices = set(state_dict["processed_indices"])
        self.reset()
