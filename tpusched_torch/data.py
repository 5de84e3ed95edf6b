"""Input pipeline: document packing and a deterministic token stream on the
card.

Counterpart of ``tpusched/jaxbridge/data.py``. :func:`pack_documents` is the
reference's numpy packer. :class:`TokenBatcher` draws the reference's
stream bit for bit (a numpy generator seeded by ``SeedSequence((seed,
step))``) and yields the GLOBAL (batch, seq) batch on the device, because
the port's train steps take the global batch and split its rows over the
batch axes themselves (``workload.TrainShardings.local``); every rank of a
mesh draws the same stream. That is the counterpart of the reference's
``sharding=``, which places each shard's rows on its device.

One batch of lookahead, as in the reference: the next batch is synthesized
into pinned host memory and copied to the card on a side stream while the
consumer runs its step on the current one; the consumer's stream waits on
the copy's event before the batch is handed over.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .workload import ModelConfig, resolve_device


def pack_documents(docs, seq: int, eos: int, pad: int = 0) -> np.ndarray:
    """Greedy packing: variable-length token documents become fixed (rows,
    seq) int32 rows, each document ended by ``eos``, the last row padded
    with ``pad``. A document longer than a row runs on into the next; the
    packer is flatten-then-reshape, O(n). Attention may cross documents
    within a row (the simple packing regime)."""
    flat: list = []
    for doc in docs:
        flat.extend(doc)
        flat.append(eos)
    if not flat:
        return np.zeros((0, seq), dtype=np.int32)
    flat.extend([pad] * (-len(flat) % seq))
    return np.asarray(flat, dtype=np.int32).reshape(-1, seq)


class TokenBatcher:
    """Deterministic synthetic LM batches: a seeded stream over the vocab,
    yielding (batch, seq) int64 tensors (the train steps' token dtype) on
    ``mesh.device`` with a mesh, else on ``device`` (the card unless
    ``device="cpu"``). The stream is a pure function of (seed, batch, seq,
    vocab), so a restarted job that starts at ``start_step`` resumes it
    exactly: the data half of checkpoint and resume."""

    def __init__(self, cfg: ModelConfig, batch: int, mesh=None,
                 seed: int = 0, start_step: int = 0, device=None):
        if mesh is not None and mesh.device is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"the mesh runs on {mesh.device}, not "
                                 f"{device}")
            device = mesh.device
        self.cfg = cfg
        self.batch = batch
        self.seed = seed
        self.start_step = start_step
        self.device = resolve_device(device)

    def _host_batch(self, step: int) -> np.ndarray:
        """Batch ``step`` as the reference's int32 numpy array."""
        # SeedSequence keeps (seed, step) pairs distinct for any step
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, step)))
        return rng.integers(0, self.cfg.vocab,
                            size=(self.batch, self.cfg.seq), dtype=np.int32)

    def _put(self, step: int, stream):
        host = torch.from_numpy(self._host_batch(step).astype(np.int64))
        if stream is None:
            return host.to(self.device), None
        host = host.pin_memory()
        with torch.cuda.stream(stream):
            out = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self) -> Iterator[torch.Tensor]:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        step = self.start_step
        pending: Optional[tuple] = None
        while True:
            nxt = self._put(step, stream)     # its copy overlaps the
            if pending is not None:           # consumer's step on pending
                out, done = pending
                if done is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(done)
                    out.record_stream(current)
                yield out
            pending = nxt
            step += 1
