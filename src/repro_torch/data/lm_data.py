"""Deterministic synthetic token pipeline, host-sharded, with prefetch.

Counterpart of ``repro.data.lm_data``, in numpy and a thread as there, so a
batch is bitwise the reference's for the same (seed, step, host). Sequences
have learnable structure (a noisy affine-bigram process) so a training run
shows a falling loss; generation is a pure function of (seed, host, step),
which makes the pipeline resumable after a restart.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.common import ArchConfig


def batch_at_step(
    cfg: ArchConfig, *, seed: int, step: int, host: int, n_hosts: int,
    batch: int, seq: int,
) -> Dict[str, np.ndarray]:
    """Pure function (seed, step, host) -> batch dict (numpy)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, host]))
    per_host = batch // n_hosts
    v = cfg.vocab
    a = 31 % v or 1
    x = np.empty((per_host, seq + 1), np.int64)
    x[:, 0] = rng.integers(0, v, size=per_host)
    noise = rng.integers(0, 7, size=(per_host, seq))
    for t in range(seq):
        x[:, t + 1] = (a * x[:, t] + 17 + noise[:, t]) % v
    out: Dict[str, np.ndarray] = {
        "tokens": x[:, :-1].astype(np.int32),
        "targets": x[:, 1:].astype(np.int32),
    }
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal(
            (per_host, seq, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "vlm":
        n_img = min(cfg.frontend_tokens, max(seq // 2, 8))
        out["patch_embeds"] = rng.standard_normal(
            (per_host, n_img, cfg.d_model)
        ).astype(np.float32)
    return out


class PrefetchingLoader:
    """Background-thread prefetch of the deterministic pipeline: yields
    ``(step, batch)`` from ``start_step`` on. ``close`` stops the thread."""

    def __init__(self, cfg: ArchConfig, *, seed: int, batch: int, seq: int,
                 host: int = 0, n_hosts: int = 1, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg, self.seed = cfg, seed
        self.batch, self.seq = batch, seq
        self.host, self.n_hosts = host, n_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            b = batch_at_step(
                self.cfg, seed=self.seed, step=step, host=self.host,
                n_hosts=self.n_hosts, batch=self.batch, seq=self.seq,
            )
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
