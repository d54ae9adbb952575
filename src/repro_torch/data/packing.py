"""Document pipeline: tokenized-document stream -> packed fixed-length
training batches (greedy first-fit packing, cross-document attention masked
by a segment-aware loss mask), plus a shuffle buffer.

This is the substrate a production trainer feeds from; `token_stream`
(synthetic bigram) remains the quick-example source.

A copy of ``repro.data.packing``, which is numpy only: the port keeps its
own so that it never imports the JAX package.  Batches are numpy arrays;
``model.loss_fn`` takes them as they are.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np


def synthetic_documents(vocab: int, seed: int = 0,
                        mean_len: int = 180) -> Iterator[np.ndarray]:
    """Endless stream of variable-length 'documents' (geometric lengths)."""
    rng = np.random.default_rng(seed)
    while True:
        n = int(np.clip(rng.geometric(1.0 / mean_len), 8, 8 * mean_len))
        yield rng.integers(0, vocab, n).astype(np.int32)


def shuffle_buffer(stream: Iterable[np.ndarray], size: int = 256,
                   seed: int = 0) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    buf: list = []
    it = iter(stream)
    for doc in it:
        buf.append(doc)
        if len(buf) >= size:
            i = rng.integers(0, len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()


def pack_documents(stream: Iterable[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Iterator[dict]:
    """Greedy packing of documents into (seq_len+1)-token rows.

    Yields dicts with:
      tokens   (seq_len,) int32
      labels   (seq_len,) int32 — next-token targets, -1 on pad AND on the
               first token of each document (no cross-document prediction)
      segments (seq_len,) int32 — document id within the row (0 = padding)
    """
    it = iter(stream)
    row: list = []
    seg_ids: list = []
    seg = 1
    carry: Optional[np.ndarray] = None
    while True:
        doc = carry if carry is not None else next(it)
        carry = None
        space = (seq_len + 1) - len(row)
        if space <= 1:
            pass
        elif len(doc) > space:
            row.extend(doc[:space].tolist())
            seg_ids.extend([seg] * space)
            carry = doc[space:]
        else:
            row.extend(doc.tolist())
            seg_ids.extend([seg] * len(doc))
            seg += 1
            if len(row) < seq_len + 1:
                continue
        # emit
        toks = np.full(seq_len + 1, pad_id, np.int32)
        segs = np.zeros(seq_len + 1, np.int32)
        toks[:len(row)] = row[:seq_len + 1]
        segs[:len(seg_ids)] = seg_ids[:seq_len + 1]
        labels = toks[1:].copy().astype(np.int32)
        seg_now = segs[1:]
        seg_prev = segs[:-1]
        mask_off = (seg_now == 0) | (seg_now != seg_prev)
        labels = np.where(mask_off, -1, labels)
        yield {"tokens": toks[:-1], "labels": labels,
               "segments": segs[:-1]}
        row, seg_ids, seg = [], [], 1


def packed_batches(vocab: int, batch: int, seq_len: int, seed: int = 0,
                   buffer: int = 64) -> Iterator[dict]:
    """Batched, shuffled, packed pipeline ready for model.loss_fn."""
    docs = shuffle_buffer(synthetic_documents(vocab, seed), buffer, seed)
    rows = pack_documents(docs, seq_len)
    while True:
        items = [next(rows) for _ in range(batch)]
        yield {k: np.stack([x[k] for x in items]) for k in items[0]}


def packing_efficiency(batch_dict: dict) -> float:
    """Fraction of non-pad tokens in a packed batch."""
    return float((batch_dict["segments"] > 0).mean())
