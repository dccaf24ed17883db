"""Deterministic, resumable host data loader.

  * the batch of global step s is a pure function of (seed, s), so a
    restart resumes mid-stream by step index with no state files;
  * each data-parallel host makes only its shard (shard_id, num_shards);
  * a background thread prefetches ``prefetch`` batches ahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class ShardedLoader:
    def __init__(self, batch_fn: Callable[[int, int, int], dict], *,
                 shard_id: int = 0, num_shards: int = 1, start_step: int = 0,
                 prefetch: int = 2):
        """batch_fn(step, shard_id, num_shards) -> dict of numpy arrays
        (the local shard of the global batch); iterating yields (step,
        batch) from ``start_step`` on."""
        self.batch_fn = batch_fn
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.batch_fn(s, self.shard_id, self.num_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        """Stop the prefetch thread (it exits within 0.1 s)."""
        self._stop.set()


def lm_batch_fn(vocab: int, global_batch: int, seq: int, seed: int = 0):
    """Deterministic LM batches sharded over the batch axis."""
    from repro_torch.data.synthetic import lm_token_batch

    def fn(step: int, shard_id: int, num_shards: int) -> dict:
        if global_batch % num_shards != 0:
            raise ValueError(f"global_batch={global_batch} must shard "
                             f"evenly over {num_shards} hosts")
        local = global_batch // num_shards
        # an independent stream per (step, shard)
        x = lm_token_batch(local, seq, vocab,
                           seed=seed * 1_000_003 + step * 131 + shard_id)
        return {"tokens": x[:, :-1], "targets": x[:, 1:]}

    return fn
