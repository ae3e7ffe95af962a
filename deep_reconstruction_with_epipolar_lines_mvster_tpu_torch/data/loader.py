"""Host-side input pipeline: threaded prefetching batch loader.

The port's copy of the JAX package's ``data/loader.py`` (numpy only).

Replaces ``torch.utils.data.DataLoader(num_workers=4)`` +
``DistributedSampler`` (reference train_mvs4.py:590-598) with a
dependency-free thread pool: per-epoch shuffled index stream, per-host
sharding (each host reads a disjoint round-robin slice — the
DistributedSampler equivalent for multihost TPU), parallel ``__getitem__``
via threads (IO-bound: PNG/PFM decode releases the GIL inside PIL/cv2/numpy),
np.stack collation, and a bounded prefetch queue so decode overlaps device
compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack sample dicts (nested) along a new leading batch axis; non-array
    leaves (e.g. ``filename`` strings) are collected into lists."""
    first = samples[0]

    def stack(key_samples):
        head = key_samples[0]
        if isinstance(head, dict):
            return {k: stack([s[k] for s in key_samples]) for k in head}
        if isinstance(head, np.ndarray):
            return np.stack(key_samples)
        return list(key_samples)

    return {k: stack([s[k] for s in samples]) for k in first}


class DataLoader:
    """Iterable over collated batches of a map-style dataset.

    Args:
      dataset: object with ``__len__`` / ``__getitem__ -> sample dict``.
      batch_size: samples per (per-host) batch.
      shuffle: reshuffle indices each epoch (seeded, epoch-dependent).
      drop_last: drop the trailing partial batch (train: True, reference
        train_mvs4.py:594).
      num_workers: decode threads (0 = synchronous).
      num_hosts / host_id: shard the index stream round-robin across hosts.
      seed: shuffle seed; ``set_epoch`` advances the stream like
        ``DistributedSampler.set_epoch``.
      rank_in_host / ranks_in_host: load only this rank's contiguous share
        of each host batch (``ranks_in_host`` must divide ``batch_size``;
        ``parallel.mesh.split_batch`` of the host batch, without decoding
        the other ranks' samples). A trailing batch that the ranks do not
        divide (``drop_last=False``) is first wrapped up to a multiple of
        them (``parallel.mesh.pad_batch_to_multiple``), and each rank's
        share of it carries the float32 ``valid`` mask (1 real, 0 padded).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        num_hosts: int = 1,
        host_id: int = 0,
        seed: int = 0,
        prefetch: int = 2,
        rank_in_host: int = 0,
        ranks_in_host: int = 1,
    ):
        if batch_size % ranks_in_host:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{ranks_in_host} ranks of a host")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.seed = seed
        self.prefetch = prefetch
        self.rank_in_host = rank_in_host
        self.ranks_in_host = ranks_in_host
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # advance the dataset's per-sample augmentation RNG stream too
        ds_set_epoch = getattr(self.dataset, "set_epoch", None)
        if callable(ds_set_epoch):
            ds_set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_hosts > 1:
            # pad to a multiple of num_hosts so every host sees the same
            # number of samples (DistributedSampler semantics)
            pad = (-len(idx)) % self.num_hosts
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.host_id :: self.num_hosts]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _share(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        """This rank's share of the host batch of indices ``batch``:
        ``{"i": indices}``, with ``valid`` where the batch was padded."""
        share = {"i": batch}
        if self.ranks_in_host > 1:
            from ..parallel.mesh import pad_batch_to_multiple, split_batch

            share = split_batch(pad_batch_to_multiple(share, self.ranks_in_host),
                                self.rank_in_host, self.ranks_in_host)
        return share

    def _collate(self, share: Dict[str, np.ndarray], samples) -> Dict[str, Any]:
        batch = collate(samples)
        if "valid" in share:
            batch["valid"] = share["valid"]
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._indices()
        n_batches = len(self)
        shares = [
            self._share(indices[i * self.batch_size : (i + 1) * self.batch_size])
            for i in range(n_batches)
        ]
        if self.num_workers <= 0:
            for s in shares:
                yield self._collate(s, [self.dataset[int(i)] for i in s["i"]])
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def producer():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for s in shares:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, map(int, s["i"])))
                        out_q.put(self._collate(s, samples))
            except BaseException as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
