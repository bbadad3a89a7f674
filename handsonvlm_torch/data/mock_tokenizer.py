"""Deterministic word-level tokenizer with sentencepiece-like conventions.

Used for offline tests and benchmarks (the real Vicuna sentencepiece model
is not shipped with this repo). Mirrors the properties the preprocessing
arithmetic depends on:

- BOS (1) prepended to every encode; EOS "</s>" maps to 2;
- added special tokens (<t0>..<t99> = 32000.., <hand_traj> = 32100) split
  atomically even without surrounding whitespace;
- a trailing space yields a standalone space token (29871), matching
  sentencepiece's behavior for prompts ending in "USER: " / "ASSISTANT: "
  (this is what makes the reference's `instruction_len - 2` masking and the
  `tokenizer_image_token` offset arithmetic come out right);
- regular words hash to stable ids in [3000, 30000).
"""

from __future__ import annotations

import hashlib
import re
from typing import List

from handsonvlm_torch.constants import (
    HAND_TOKEN_TEMPLATE,
    NUM_TIME_TOKENS,
    TIME_TOKEN_TEMPLATE,
)

SPACE_TOKEN_ID = 29871
_WORD_RANGE = (3000, 30000)


class MockTokenizer:
    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 0

    def __init__(self, model_max_length: int = 2048):
        self.model_max_length = model_max_length
        self.pad_token_id = 0
        self.special = {"<s>": 1, "</s>": 2, "<unk>": 0}
        for i in range(NUM_TIME_TOKENS):
            self.special[TIME_TOKEN_TEMPLATE.format(t=i)] = 32000 + i
        self.special[HAND_TOKEN_TEMPLATE] = 32100
        self.hand_token_id = 32100
        self._split_re = re.compile(
            "(" + "|".join(re.escape(t) for t in sorted(self.special, key=len, reverse=True)) + ")"
        )
        self._vocab_size = 32101
        self._id_to_word = {}

    def __len__(self):
        return self._vocab_size

    def _word_id(self, word: str) -> int:
        lo, hi = _WORD_RANGE
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        wid = lo + (h % (hi - lo))
        self._id_to_word[wid] = word
        return wid

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_token_id]
        for piece in self._split_re.split(text):
            if not piece:
                continue
            if piece in self.special:
                ids.append(self.special[piece])
                continue
            for word in piece.split():
                ids.append(self._word_id(word))
            if piece != piece.rstrip(" ") and piece.strip():
                ids.append(SPACE_TOKEN_ID)  # sentencepiece-style trailing space
            elif not piece.strip() and piece.strip(" ") != piece:
                ids.append(SPACE_TOKEN_ID)
        return ids

    def decode(self, ids) -> str:
        inv_special = {v: k for k, v in self.special.items()}
        words = []
        for i in ids:
            i = int(i)
            if i in inv_special:
                words.append(inv_special[i])
            elif i == SPACE_TOKEN_ID:
                continue
            elif i == self.bos_token_id:
                continue
            else:
                words.append(self._id_to_word.get(i, f"<{i}>"))
        return " ".join(words)

    # HF-compatible call surface used by the reference preprocess code
    def __call__(self, text, **kwargs):
        class _Out:
            def __init__(self, ids):
                self.input_ids = ids

        if isinstance(text, str):
            return _Out(self.encode(text))
        return _Out([self.encode(t) for t in text])
