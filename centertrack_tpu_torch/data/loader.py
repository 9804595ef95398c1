"""Prefetching batch loader with thread or fork-process workers
(reference: main.py:52-65, --num_workers; JAX: data/loader.py).

One deterministic mode: after the epoch's shuffle, the loader draws one
seed per item from its own stream, in batch order, and the item is built
by ``dataset.item(index, seed)``, which seeds the item's draws and its
colour jitter from it exactly as JAX's process workers do
(``_proc_get``). So the batches are the same whatever the number or the
kind of workers, and equal to JAX's ``use_processes=True`` batches.
Threads are the default; ``use_processes=True`` forks workers, each
holding the dataset (make the loader before the process starts threads
of its own: forking a threaded process can deadlock).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

_worker_ds = None


def _proc_init(dataset):
    global _worker_ds
    _worker_ds = dataset


def _proc_get(args):
    idx, seed = args
    return _worker_ds.item(int(idx), seed)


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples], axis=0)
            for k in samples[0]}


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True,
                 prefetch: int = 4, seed: int = 317,
                 use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.use_processes = use_processes
        # the producer's wall seconds for each batch of the last epoch
        self.batch_seconds: List[float] = []
        self.producer = None   # the last epoch's producer thread

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _plan(self):
        """The epoch's batches of (index, seed): the shuffle, then one
        seed per item in batch order, as JAX's process mode draws them."""
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(indices)
        batches = []
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            batches.append([(int(j), int(self.rng.randint(1 << 31)))
                            for j in chunk])
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._plan()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        self.batch_seconds = []

        def put(item) -> bool:
            """Hands ``item`` over unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            if self.use_processes:
                import multiprocessing
                pool = ProcessPoolExecutor(
                    self.num_workers, initializer=_proc_init,
                    initargs=(self.dataset,),
                    mp_context=multiprocessing.get_context("fork"))
                fetch = lambda chunk: pool.map(_proc_get, chunk)
            else:
                pool = ThreadPoolExecutor(self.num_workers)
                fetch = lambda chunk: pool.map(
                    lambda a: self.dataset.item(*a), chunk)
            try:
                for chunk in batches:
                    if stop.is_set():
                        return
                    t = time.perf_counter()
                    batch = collate(list(fetch(chunk)))
                    self.batch_seconds.append(time.perf_counter() - t)
                    if not put(batch):
                        return
            except BaseException as e:   # handed to the consumer
                put(e)
                return
            finally:
                pool.shutdown(wait=True, cancel_futures=True)
            put(None)

        # a consumer that stops early (a break, a raised step) closes this
        # generator: the producer sees ``stop`` at its next hand-over, shuts
        # its pool down and ends before the close returns
        self.producer = threading.Thread(target=produce, daemon=True)
        self.producer.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            self.producer.join()
