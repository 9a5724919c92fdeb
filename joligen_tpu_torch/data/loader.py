"""Threaded prefetching batch loader producing fixed-shape numpy batches: a
copy of ``joligen_tpu/data/loader.py``, stacking with numpy (the g++ helper
``native/batch_ops.cpp`` is not ported, ROADMAP Queue 1 item 4, dataset
modes).

Replaces the reference's torch DataLoader (data/__init__.py:109-162) for
one rank: worker threads decode/crop samples (PIL releases the GIL),
``None`` samples are filtered like the reference collate_fn
(data/__init__.py:81-86), and full batches are queued ahead of the train
loop so host input prep overlaps device compute.
"""

from __future__ import annotations

import queue
import random
import threading

import numpy as np


def collate(samples):
    """Stack dict-of-arrays samples; non-array fields become lists.
    Keys present in only SOME samples are dropped with a warning — a
    shorter stacked field would silently pair row i with the wrong
    sample downstream."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples if k in s]
        if len(vals) != len(samples):
            print(f"collate: key '{k}' present in {len(vals)}/"
                  f"{len(samples)} samples — dropped this batch")
            continue
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=True, num_workers=4,
                 drop_last=True, prefetch=4, seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self):
        indices = self._epoch_indices()
        sample_q: queue.Queue = queue.Queue(maxsize=self.prefetch * self.batch_size)
        stop = threading.Event()

        chunks = [c for c in
                  (indices[i::self.num_workers] for i in range(self.num_workers))
                  if c]

        def _put(item):
            # bounded put that keeps observing stop: a worker blocked in a
            # plain put() on a full queue outlives an abandoned iterator
            # (e.g. metric evals that break out early) forever
            while not stop.is_set():
                try:
                    sample_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(chunk, wid):
            for i in chunk:
                if stop.is_set():
                    return
                try:
                    s = self.dataset[i]
                except Exception as e:
                    print(f"dataloader worker: sample {i} failed: {e}")
                    s = None
                if not _put((wid, s)):
                    return
            _put((wid, StopIteration))

        threads = [threading.Thread(target=worker, args=(c, w), daemon=True)
                   for w, c in enumerate(chunks)]
        for t in threads:
            t.start()

        try:
            live = len(chunks)
            batch = []
            while live > 0:
                wid, s = sample_q.get()
                if s is StopIteration:
                    live -= 1
                    continue
                if s is None:
                    continue
                batch.append(s)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield collate(batch)
        finally:
            stop.set()
