"""Hash tokenizer with input-domain reduction (paper §4.1), a numpy copy
of ``repro.data.tokenizer``.

The paper's local models use a reduced input domain: a small dictionary
(2000 most frequent words) and clipped sequence length (IMDB: 100 words).
`HashTokenizer` is a deterministic, dependency-free stand-in: words hash
into a full-size id space for the remote model, and `reduce_domain` maps
ids into the local model's reduced dictionary (out-of-dict -> UNK),
mirroring the local/remote asymmetry.

``encode`` uses Python's ``hash()``, which is salted per process: two
processes give different ids for one word, two tokenizers in one process
(this one and the JAX package's) the same.
"""

from __future__ import annotations

import numpy as np

PAD, UNK = 0, 1


class HashTokenizer:
    def __init__(self, vocab_size: int):
        if vocab_size <= 2:
            raise ValueError(f"vocab_size {vocab_size} leaves no id past "
                             f"PAD and UNK")
        self.vocab_size = vocab_size

    def encode(self, text: str, max_len: int) -> np.ndarray:
        ids = [(hash(w) % (self.vocab_size - 2)) + 2
               for w in text.lower().split()][:max_len]
        out = np.full((max_len,), PAD, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: list[str], max_len: int) -> np.ndarray:
        return np.stack([self.encode(t, max_len) for t in texts])


def reduce_domain(tokens: np.ndarray, local_vocab: int,
                  local_len: int) -> np.ndarray:
    """Input-domain reduction: clip length, map out-of-dict ids to UNK.
    Deterministic (id-order) frequency proxy: ids < local_vocab survive."""
    clipped = tokens[..., :local_len]
    return np.where((clipped >= local_vocab) & (clipped != PAD), UNK,
                    clipped).astype(np.int32)
