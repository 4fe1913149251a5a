"""Byte-level tokenizer: 256 byte tokens + specials (copy of
``repro/data/tokenizer.py``).  Stands in for the HF tokenizer in the
paper's pipeline; everything downstream only needs ``encode/decode`` +
special ids."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    PAD, BOS, EOS = 256, 257, 258

    def __init__(self):
        self.vocab_size = 259
        self.pad_id, self.bos_id, self.eos_id = self.PAD, self.BOS, self.EOS

    def encode(self, text: str, max_len: int | None = None,
               add_bos=True, add_eos=False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        if max_len is not None:
            ids = ids[:max_len] + [self.PAD] * max(0, max_len - len(ids))
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")
