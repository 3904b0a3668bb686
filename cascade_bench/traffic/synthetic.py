"""The synthetic task: token sequences labelled by a noisy linear teacher.

A copy of ``make_classification_task`` from the port's
``data/synthetic.py`` (the same arithmetic, rewritten without the
program), so that the benchmark's inputs cannot move with the program:
token sequences whose label is a noisy readout of bag-of-token features,
which a small model learns in part and a large one better. The teacher
is drawn once (``teacher``) and the examples in blocks (``examples``),
each block from a generator of its own, so that a run draws only the
blocks it serves and any block can be drawn again alone.
"""

from __future__ import annotations

import numpy as np


def teacher(rng: np.random.Generator, *, vocab: int, seq_len: int,
            num_classes: int) -> np.ndarray:
    """The readout [vocab, num_classes] that labels every example."""
    return rng.standard_normal((vocab, num_classes)) / np.sqrt(seq_len)


def examples(rng: np.random.Generator, teach: np.ndarray, *, n: int,
             seq_len: int, label_noise: float = 0.05):
    """(tokens [n, seq_len] int32 in [1, vocab), labels [n] int32)."""
    vocab, num_classes = teach.shape
    tokens = rng.integers(1, vocab, size=(n, seq_len), dtype=np.int32)
    feats = np.zeros((n, num_classes))
    for c in range(0, seq_len, 64):
        feats += teach[tokens[:, c:c + 64]].sum(axis=1)
    pair = teach[tokens[:, ::2]].sum(1) * teach[tokens[:, 1::2]].sum(1)
    labels = np.argmax(feats + 0.5 * pair, axis=-1).astype(np.int32)
    flip = rng.random(n) < label_noise
    labels[flip] = rng.integers(0, num_classes, size=int(flip.sum()))
    return tokens, labels


def local_view(tokens: np.ndarray, max_len: int, vocab: int) -> np.ndarray:
    """The local tier's input-domain-reduced view: the sequence clipped
    to ``max_len`` and the vocabulary folded onto ``vocab`` (0 pads)."""
    return (tokens[:, :max_len] % vocab).astype(np.int32)
