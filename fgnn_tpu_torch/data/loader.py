"""Host-side data loading (counterpart of ``fgnn_tpu/data/loader.py``).

* ``Prefetcher`` / ``prefetch``: a background thread keeps a bounded
  queue of ready batches while the card steps.
* ``device_prefetch``: the same, and the thread also stages each batch on
  the device.  On CUDA it copies from pinned host memory on a stream of its
  own; the consumer's stream waits on an event recorded after the copies,
  and the staged tensors are recorded on the consumer's stream, so a batch
  is never read before it lands and its memory is never reused while the
  consumer's work on it is queued.  On the CPU the put is the identity.
* ``PoolBatcher``: worker processes synthesise the samples of CPU-bound
  generators (the RPGM oracles, LDPC words), each sample drawn from an RNG
  seeded by (seed, global sample index), so that the stream does not
  depend on the number of workers.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class Prefetcher:
    """Wrap a batch iterator with a bounded background-thread prefetch.

    ``close()`` (or leaving a ``with`` block) stops the thread and drops
    the staged batches, also mid-stream.  An error of the producer is
    raised in the consumer, after the batches produced before it."""

    def __init__(self, it: Iterator, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False

        def put(item) -> bool:
            # a bounded wait, so that a stop is seen while the queue is
            # full and the consumer has gone
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                # the marker waits as an item does: dropped when the
                # queue is full, it would leave the consumer blocked
                put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker and drop the staged items (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch(it: Iterator, depth: int = 4) -> Prefetcher:
    """``for batch in prefetch(ds.batches(bs)):``, synthesis overlapped."""
    return Prefetcher(it, depth)


def to_device(batch: dict, device, non_blocking: bool = False) -> dict:
    """Each array of ``batch`` as a tensor on ``device``; with
    ``non_blocking`` on CUDA the copy goes from pinned host memory and is
    queued on the current stream."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            if non_blocking and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=non_blocking)
        out[k] = t
    return out


class _DevicePrefetcher(Prefetcher):
    """Hands out (staged batch, event) pairs as staged batches on the
    consumer's stream; see ``device_prefetch``."""

    def __next__(self):
        staged, ready = super().__next__()
        if ready is not None:
            stream = torch.cuda.current_stream(ready.device)
            stream.wait_event(ready)
            for t in staged.values():
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
        return staged


def device_prefetch(it: Iterator, device, depth: int = 3,
                    put: Optional[Callable] = None) -> Prefetcher:
    """Prefetch batches and stage them on ``device`` from the prefetch
    thread, so that the host-to-device copies overlap the card's work on
    the previous step.

    ``put(batch)`` returns the staged dict (default: ``to_device``); it
    runs in the thread.  On CUDA it runs under a copy stream of its own
    with non-blocking copies from pinned memory, and the consumer's stream
    waits for them before it reads the batch.  On the CPU ``put`` runs as
    it is."""
    device = torch.device(device)
    if device.type != "cuda":
        stage = put or (lambda b: to_device(b, device))
        return _DevicePrefetcher(((stage(b), None) for b in it), depth)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device)
    stage = put or (lambda b: to_device(b, device, non_blocking=True))

    def staged():
        for b in it:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                out = stage(b)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            yield out, ready

    return _DevicePrefetcher(staged(), depth)


def worker_context():
    """The multiprocessing context of the data workers: fork where this
    process has not initialised CUDA, else spawn (see ``PoolBatcher``)."""
    import multiprocessing as mp

    return mp.get_context("spawn" if torch.cuda.is_initialized()
                          else "fork")


class PoolBatcher:
    """Multiprocess batch synthesis for CPU-bound sample generators.

    ``make_dataset`` is a zero-argument callable returning an object with
    ``.sample()`` drawing from ``.rng``; it is pickled when the pool
    spawns.  Every sample is drawn from an RNG seeded by (``seed``, global
    sample index), so one ``seed`` gives the same stream whatever the
    number of workers or their scheduling.

    The workers synthesise numpy samples and never touch CUDA.  The pool
    forks when this process has not initialised CUDA (the trainers build
    it before their first CUDA call, as the JAX trainers fork before their
    backend starts): forking is quick and needs nothing pickled.  In a
    process that holds a CUDA context it spawns instead: a forked child
    would copy a live driver state and its threads' locks, which CUDA does
    not support; spawned workers start clean interpreters that import the
    numpy data layer only."""

    def __init__(self, make_dataset: Callable, batch_size: int,
                 n_workers: int = 4, seed: int = 0):
        self.batch_size = batch_size
        self.seed = seed
        ctx = worker_context()
        self.start_method = ctx.get_start_method()
        self._pool = ctx.Pool(
            n_workers, initializer=_pool_init, initargs=(make_dataset,))
        self._cursor = 0  # global sample counter: the per-sample seeds

    def batches(self, n_batches: int) -> Iterator[dict]:
        for _ in range(n_batches):
            seeds = [(self.seed, self._cursor + i)
                     for i in range(self.batch_size)]
            self._cursor += self.batch_size
            items = self._pool.map(_pool_sample, seeds)
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}

    def close(self):
        self._pool.terminate()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_POOL_DS = None


def _pool_init(make_dataset):
    global _POOL_DS
    _POOL_DS = make_dataset()


def _pool_sample(seed_idx):
    base_seed, idx = seed_idx
    # a per-sample stream, whichever worker draws it
    ss = np.random.SeedSequence([base_seed, idx])
    _POOL_DS.rng = np.random.RandomState(ss.generate_state(1)[0] % (2**31))
    return _POOL_DS.sample()
