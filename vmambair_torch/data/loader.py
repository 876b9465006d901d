"""Data loading: the sampler, a threaded prefetching loader and the device
prefetcher.

The port's counterpart of `vmambair_tpu/data/loader.py`:

* `EnlargedSampler` enlarges the dataset by `ratio` so that epoch
  boundaries do not interrupt long runs, shuffles per epoch from a seeded
  numpy generator and slices indices per replica, as JAX's does.
* `DataLoader` decodes samples on worker threads, each with its own
  `random.Random` stream seeded as JAX's (so one worker gives JAX's
  batches for a seed), and yields collated numpy batches in order, at most
  `prefetch_batches` ahead of the consumer.
* `InfinitePrefetcher` turns the loader into a never-ending iterator that
  advances epochs.
* `DevicePrefetcher` issues batch N+1's host-to-device copy on a CUDA side
  stream when it hands batch N over: the copy comes from pinned memory with
  `non_blocking=True` (`put`, normally `SRModel.put_batch`, does both), the
  consumer's stream waits for the side stream before the batch is used,
  and each tensor is marked as used on the consumer's stream
  (`record_stream`), so that its memory is not handed to a later copy
  while a step still reads it. Without the wait or the marking, batch N+1
  could be read early or overwritten, and nothing would report it.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


class EnlargedSampler:
    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 1, shuffle: bool = True, seed: int = 0,
                 round_multiple: Optional[int] = None):
        """round_multiple: the granularity the virtual dataset size is
        padded to (indices wrap modulo dataset_len), so that a dataset
        smaller than the global batch still yields a batch."""
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.shuffle = shuffle
        self.seed = seed
        g = math.lcm(num_replicas, round_multiple or 1)
        self.total_size = -(-dataset_len * ratio // g) * g
        self.num_samples = self.total_size // num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            indices = np.random.RandomState(
                self.seed + self.epoch).permutation(self.total_size)
        else:
            indices = np.arange(self.total_size)
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter((indices % self.dataset_len).tolist())


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = (np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray)
                    else vals)
    return out


class DataLoader:
    """Threaded, order-preserving, prefetching batch loader."""

    def __init__(self, dataset, batch_size: int = 1, sampler=None,
                 shuffle: bool = False, num_workers: int = 4,
                 drop_last: bool = True, prefetch_batches: int = 4,
                 seed: int = 0, collate_fn=default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self.collate_fn = collate_fn
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self) -> List[int]:
        if self.sampler is not None:
            return list(self.sampler)
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        cond = threading.Condition()
        state = {"next_task": 0, "consumed": 0, "stop": False}
        results: Dict[int, Any] = {}

        def worker(worker_id: int):
            rng = random.Random(self.seed * 100003 + self._epoch * 1009
                                + worker_id)
            while True:
                with cond:
                    while (not state["stop"] and state["next_task"]
                           >= state["consumed"] + self.prefetch_batches):
                        cond.wait()
                    bi = state["next_task"]
                    if state["stop"] or bi >= len(batches):
                        return
                    state["next_task"] += 1
                try:
                    res = self.collate_fn([self.dataset.__getitem__(i, rng=rng)
                                           for i in batches[bi]])
                except Exception as e:  # handed to the consumer, raised there
                    res = e
                with cond:
                    results[bi] = res
                    cond.notify_all()

        for w in range(self.num_workers):
            threading.Thread(target=worker, args=(w,), daemon=True).start()
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in results:
                        cond.wait()
                    res = results.pop(bi)
                    state["consumed"] = bi + 1
                    cond.notify_all()
                if isinstance(res, Exception):
                    raise res
                yield res
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()


class InfinitePrefetcher:
    """A DataLoader as a never-ending iterator that advances epochs."""

    def __init__(self, loader: DataLoader, start_epoch: int = 0):
        self.loader = loader
        self.epoch = max(0, start_epoch)
        self.loader.set_epoch(self.epoch)
        self._it = iter(self.loader)

    def next(self):
        batch = next(self._it, None)
        if batch is None:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self._it = iter(self.loader)
            batch = next(self._it, None)
            if batch is None:
                raise RuntimeError(
                    "train loader yields no batches: dataset smaller than "
                    "the global batch (len(dataset) * enlarge_ratio < "
                    "batch_size_per_gpu * num_gpu after drop_last)?")
        return batch

    def close(self):
        """Stops the loader's worker threads."""
        self._it.close()


class DevicePrefetcher:
    """One batch ahead on the device. put(batch) -> batch with its tensors
    on `device` (it copies from pinned memory with non_blocking=True);
    transform(batch, seq), if given, runs on the host before the copy, with
    the 1-based number of the step that will consume the batch (the
    progressive-learning crops). On a CUDA device `put` runs on a side
    stream."""

    def __init__(self, prefetcher: InfinitePrefetcher, put, device,
                 transform=None):
        self.prefetcher = prefetcher
        self.put = put
        self.transform = transform
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._seq = 0
        self._next: Optional[Dict[str, Any]] = None
        self._preload()

    @property
    def epoch(self):
        return self.prefetcher.epoch

    def _preload(self):
        batch = self.prefetcher.next()
        self._seq += 1
        if self.transform is not None:
            batch = self.transform(batch, self._seq)
        if self.stream is None:
            self._next = self.put(batch)
            return
        with torch.cuda.stream(self.stream):
            self._next = self.put(batch)

    def next(self) -> Dict[str, Any]:
        batch = self._next
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for v in batch.values():
                if torch.is_tensor(v) and v.device.type == "cuda":
                    v.record_stream(current)
        self._preload()
        return batch

    def close(self):
        self.prefetcher.close()
