"""Deterministic synthetic LM data pipeline (numpy only).

The port's own copy of ``repro/data/pipeline.py``: the same generator calls
in the same order, so every batch is bit-identical to the JAX package's for
the same (seed, step, host slice).  Batches are numpy arrays; the training
step moves them to its device.

* **Stateless in (seed, step)**: every batch is a pure function of the run
  seed and the global step, so a restarted job replays the exact token
  stream with no pipeline state in its checkpoints.
* **Host-sharded**: each host materializes only its slice of the global
  batch (``host_index`` of ``n_hosts``).
* **Prefetched**: a background thread keeps ``prefetch`` batches ready so
  step N+1's data is built while step N runs.

The stream is a Zipf-ish unigram mixture with short repeated motifs: a
*learnable* distribution (the loss falls measurably in a few hundred steps)
rather than white noise.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLMData:
    def __init__(self, cfg: DataConfig, *, host_index: int = 0, n_hosts: int = 1,
                 extras: dict | None = None):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.extras = extras or {}
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank: repeated n-grams the model can learn to predict
        self._motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._unigram = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """The global-step batch slice for this host. Pure in (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.host_index)
        B, T = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(B, T + 1), p=self._unigram).astype(np.int32)
        # splice motifs over ~half the positions => learnable structure
        n_splice = max(1, T // (2 * cfg.motif_len))
        for b in range(B):
            idx = rng.integers(0, cfg.n_motifs, size=n_splice)
            pos = rng.integers(0, T + 1 - cfg.motif_len, size=n_splice)
            for m, s in zip(idx, pos):
                toks[b, s : s + cfg.motif_len] = self._motifs[m]
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": np.ones((B, T), np.float32),
        }
        for name, (shape, dtype) in self.extras.items():
            # modality stubs (patch_embeds / frames): deterministic in step
            batch[name] = rng.standard_normal((B, *shape)).astype(dtype)
        return batch

    def iterate(self, start_step: int = 0, *, prefetch: int = 2):
        """Prefetching iterator: yields (step, batch) from start_step on."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch_at(step)))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass
