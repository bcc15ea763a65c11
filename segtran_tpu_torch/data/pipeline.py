"""Input pipeline: seeded per-epoch order, thread-pool loading, and a
device prefetcher (counterpart of ``segtran_tpu/data/pipeline.py``; the
reference's DataLoader(num_workers=4) + DistributedSampler).

``epoch_indices`` gives the JAX package's permutation for the same seed
and epoch; evaluation walks the dataset in order (``shuffle=False``) and
keeps the last partial batch (``drop_last=False``). ``DevicePrefetcher`` copies each batch into page-locked host
memory on a loader thread and uploads it on a side CUDA stream one batch
ahead of the step that uses it.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.norm import shard_rows


def epoch_indices(n: int, epoch: int, seed: int = 0,
                  shuffle: bool = True) -> np.ndarray:
    """DistributedSampler.set_epoch: a deterministic permutation per
    epoch; in order without ``shuffle``."""
    if not shuffle:
        return np.arange(n)
    rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2 ** 31))
    return rng.permutation(n)


def _stack(samples: Sequence[dict], keys: Optional[Sequence[str]] = None
           ) -> Dict[str, np.ndarray]:
    keys = keys or [k for k, v in samples[0].items()
                    if isinstance(v, (np.ndarray, np.floating, np.integer,
                                      float, int))]
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}


def batch_iterator(dataset, batch_size: int, epoch: int, seed: int = 0,
                   shuffle: bool = True, drop_last: bool = True,
                   keys: Optional[Sequence[str]] = None,
                   shard: Tuple[int, int] = (0, 1), microbatches: int = 1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Stacked numpy batches of one epoch in epoch_indices order (the
    dataset's own order without ``shuffle``); the last partial batch is
    dropped with ``drop_last``, else yielded short. Samples load on 4
    threads. ``shard`` (index, count): a data-parallel rank's share --
    every rank walks the same global batches of ``batch_size`` and loads
    only its rows, contiguous in each of the step's ``microbatches``
    (``ops.norm.shard_rows``; JAX's ``P("data")`` layout)."""
    rows = shard_rows(batch_size, *shard, microbatches)
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    idx = epoch_indices(len(dataset), epoch, seed, shuffle)
    n = len(idx)
    if drop_last:
        n = (n // batch_size) * batch_size
        if n == 0:
            raise ValueError(
                f"dataset has {len(idx)} samples, fewer than the batch size "
                f"{batch_size}: lower --bs or add data")
    with ThreadPoolExecutor(max_workers=4) as pool:
        for s in range(0, n, batch_size):
            part = idx[s:s + batch_size]
            if len(part) == batch_size:
                part = part[rows]
            yield _stack(list(pool.map(dataset.__getitem__, part)), keys)


class DevicePrefetcher:
    """Iterate ``it``'s numpy batches as tensors on ``device``. A loader
    thread stacks and pins up to 2 batches ahead; on CUDA each is
    uploaded on a side stream while the step before it runs, and the
    consumer's stream waits for that upload only."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._load, args=(it,),
                                        daemon=True)
        self._thread.start()

    _END = object()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer has closed; False if it has."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _load(self, it):
        try:
            for batch in it:
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in batch.items()}
                if self.cuda:
                    host = {k: v.pin_memory() for k, v in host.items()}
                if not self._put(host):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            self._put(e)
            return
        self._put(self._END)

    def _upload(self, host):
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.stream):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return dev, done

    def _next_host(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def __iter__(self):
        host = self._next_host()
        if host is self._END:
            return
        nxt = self._upload(host)
        while True:
            cur = nxt
            host = self._next_host()
            nxt = None if host is self._END else self._upload(host)
            batch, done = cur
            if done is not None:
                cs = torch.cuda.current_stream(self.device)
                cs.wait_event(done)
                for v in batch.values():
                    v.record_stream(cs)
            yield batch
            if nxt is None:
                return

    def close(self):
        self._stop.set()
        while True:        # unblock a loader waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)
