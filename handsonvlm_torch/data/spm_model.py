"""Dependency-free sentencepiece `tokenizer.model` loader + encoder.

The reference tokenizes with the slow sentencepiece LlamaTokenizer
(`llava/mm_utils.py:20-77`; `handsonvlm/model/builder.py:89` loads with
`use_fast=False`). The `sentencepiece` package is not installed in this
environment, so without this module a real Vicuna checkpoint shipping only
a `tokenizer.model` file could not be tokenized at all. This implements
the minimum of sentencepiece needed for LLaMA-family models, from scratch:

- a protobuf wire-format reader for `ModelProto` (pieces + trainer_spec +
  normalizer_spec) — no protobuf dependency;
- the unigram Viterbi segmenter (model_type=UNIGRAM) maximizing summed
  piece log-probs, with unk penalty = min_score - 10.0 like spm;
- the sentencepiece BPE segmenter (model_type=BPE): best-scoring adjacent
  merge first, ties to the leftmost pair (LLaMA's shipped model is BPE);
- byte fallback: segments with no piece id expand to `<0xXX>` BYTE pieces;
- whitespace escaping (U+2581), add_dummy_prefix, remove_extra_whitespaces
  per the model's normalizer_spec. Precompiled charsmap normalization is
  NOT executed; LLaMA/Vicuna ships the "identity" normalizer so encoding
  is exact for them (a non-empty charsmap raises unless allowed).

Decode inverts all of the above (byte-piece runs are accumulated and
UTF-8-decoded together, control pieces are skipped).
"""

from __future__ import annotations

import dataclasses
import heapq
import struct
from typing import Dict, List, Optional, Tuple

# ModelProto.SentencePiece.Type values (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

UNIGRAM = 1
BPE = 2

_WS = "▁"  # the sentencepiece whitespace escape "▁"


# ---------------------------------------------------------------------------
# protobuf wire-format reader (just what ModelProto needs)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value). value is int for varint/
    fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} for field {field}")
        yield field, wire, val


def _f32(raw: int) -> float:
    return struct.unpack("<f", raw.to_bytes(4, "little"))[0]


@dataclasses.dataclass
class Piece:
    piece: str
    score: float
    type: int = NORMAL


def _parse_piece(buf: bytes) -> Piece:
    piece, score, ptype = "", 0.0, NORMAL
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            piece = val.decode("utf-8")
        elif field == 2:
            score = _f32(val)
        elif field == 3:
            ptype = val
    return Piece(piece, score, ptype)


def _parse_trainer_spec(buf: bytes) -> dict:
    # field numbers from sentencepiece_model.proto TrainerSpec
    out = {"model_type": UNIGRAM, "byte_fallback": False,
           "unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": -1}
    names = {3: "model_type", 35: "byte_fallback",
             40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}
    for field, wire, val in _iter_fields(buf):
        if field in names and wire == 0:
            v = int(val)
            if field in (40, 41, 42, 43):
                # int32 two's complement (pad_id default is -1 on disk too,
                # but explicit -1 encodes as a 10-byte varint)
                if v >= 1 << 31:
                    v -= 1 << 64
            out[names[field]] = bool(v) if field == 35 else v
    return out


def _parse_normalizer_spec(buf: bytes) -> dict:
    out = {"name": "", "precompiled_charsmap": b"", "add_dummy_prefix": True,
           "remove_extra_whitespaces": True, "escape_whitespaces": True}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            out["name"] = val.decode("utf-8")
        elif field == 2:
            out["precompiled_charsmap"] = val
        elif field == 3:
            out["add_dummy_prefix"] = bool(val)
        elif field == 4:
            out["remove_extra_whitespaces"] = bool(val)
        elif field == 5:
            out["escape_whitespaces"] = bool(val)
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class SentencePieceModel:
    """Loaded `tokenizer.model`. `encode` returns raw piece ids (no BOS/EOS
    — the tokenizer wrapper owns those, like HF's LlamaTokenizer)."""

    def __init__(self, pieces: List[Piece], trainer: dict, normalizer: dict,
                 allow_charsmap: bool = False):
        if normalizer["precompiled_charsmap"] and not allow_charsmap:
            raise NotImplementedError(
                "model has a precompiled normalization charsmap, which this "
                "loader does not execute; LLaMA/Vicuna models ship the "
                "identity normalizer (pass allow_charsmap=True to encode "
                "anyway, skipping that normalization step)"
            )
        self.pieces = pieces
        self.trainer = trainer
        self.normalizer = normalizer
        self.model_type = trainer["model_type"]
        if self.model_type not in (UNIGRAM, BPE):
            raise NotImplementedError(f"model_type {self.model_type}")
        self.unk_id = trainer["unk_id"]
        self.bos_id = trainer["bos_id"]
        self.eos_id = trainer["eos_id"]
        self.pad_id = trainer["pad_id"]
        self.byte_fallback = trainer["byte_fallback"]

        self._piece_to_id: Dict[str, int] = {}
        self._byte_to_id: Dict[int, int] = {}
        self._matchable: Dict[str, Tuple[int, float]] = {}
        self._max_piece_chars = 1
        min_score = 0.0
        for i, p in enumerate(pieces):
            self._piece_to_id.setdefault(p.piece, i)
            if p.type == BYTE:
                # "<0xAB>"
                self._byte_to_id[int(p.piece[1:-1], 16)] = i
            if p.type in (NORMAL, USER_DEFINED):
                self._matchable[p.piece] = (i, p.score)
                self._max_piece_chars = max(self._max_piece_chars, len(p.piece))
                min_score = min(min_score, p.score)
        self._unk_score = min_score - 10.0  # spm kUnkPenalty

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes, **kw) -> "SentencePieceModel":
        pieces: List[Piece] = []
        trainer = _parse_trainer_spec(b"")
        normalizer = _parse_normalizer_spec(b"")
        for field, wire, val in _iter_fields(data):
            if field == 1:
                pieces.append(_parse_piece(val))
            elif field == 2:
                trainer = _parse_trainer_spec(val)
            elif field == 3:
                normalizer = _parse_normalizer_spec(val)
        if not pieces:
            raise ValueError("no pieces found — not a sentencepiece model?")
        return cls(pieces, trainer, normalizer, **kw)

    @classmethod
    def load(cls, path: str, **kw) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), **kw)

    # -- vocab --------------------------------------------------------------

    def vocab_size(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self.unk_id)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i].piece

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.normalizer["remove_extra_whitespaces"]:
            text = " ".join(x for x in text.split(" ") if x)
        if not text:
            return text
        if self.normalizer["add_dummy_prefix"]:
            text = " " + text
        if self.normalizer["escape_whitespaces"]:
            text = text.replace(" ", _WS)
        return text

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        s = self._normalize(text)
        if not s:
            return []
        segments = (self._viterbi(s) if self.model_type == UNIGRAM
                    else self._bpe(s))
        out: List[int] = []
        for seg in segments:
            hit = self._matchable.get(seg)
            if hit is not None:
                out.append(hit[0])
            elif self.byte_fallback and self._byte_to_id:
                out.extend(self._byte_to_id.get(b, self.unk_id)
                           for b in seg.encode("utf-8"))
            elif out and out[-1] == self.unk_id:
                # sentencepiece merges adjacent unknown spans into ONE unk
                # piece (normalizer keeps the span; ids see a single unk) —
                # without byte fallback, collapsing keeps token counts (and
                # the masking arithmetic built on them) aligned
                continue
            else:
                out.append(self.unk_id)
        return out

    def _viterbi(self, s: str) -> List[str]:
        """Unigram max-sum-of-scores segmentation; unknown single chars
        cost unk_score (spm lattice semantics)."""
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        cap = self._max_piece_chars
        match = self._matchable
        for i in range(n):
            bi = best[i]
            if bi == float("-inf"):
                continue
            # unknown single char is always a candidate
            sc = bi + self._unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = i
            for j in range(i + 1, min(n, i + cap) + 1):
                hit = match.get(s[i:j])
                if hit is not None:
                    sc = bi + hit[1]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = i
        segs: List[str] = []
        j = n
        while j > 0:
            i = back[j]
            segs.append(s[i:j])
            j = i
        segs.reverse()
        return segs

    def _bpe(self, s: str) -> List[str]:
        """sentencepiece BPE: repeatedly merge the adjacent pair whose
        concatenation is the best-scoring vocab piece; ties go to the
        leftmost pair (bpe_model.cc ordering)."""
        # doubly-linked symbol list over initial single chars
        syms = list(s)
        nxt = list(range(1, len(syms))) + [-1]
        prv = [-1] + list(range(len(syms) - 1))
        alive = [True] * len(syms)
        match = self._matchable

        heap: List[Tuple[float, int, int, str]] = []

        def push(i: int):
            j = nxt[i]
            if j == -1:
                return
            merged = syms[i] + syms[j]
            hit = match.get(merged)
            if hit is not None:
                # max-heap on score, then leftmost
                heapq.heappush(heap, (-hit[1], i, j, merged))

        for i in range(len(syms) - 1):
            push(i)
        while heap:
            _, i, j, merged = heapq.heappop(heap)
            if not (alive[i] and alive[j]) or nxt[i] != j or syms[i] + syms[j] != merged:
                continue  # stale entry
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i])
            push(i)
        return [syms[i] for i in range(len(syms)) if alive[i]]

    # -- decoding -----------------------------------------------------------

    def decode(self, ids) -> str:
        parts: List[str] = []
        byte_run = bytearray()

        def flush():
            if byte_run:
                parts.append(byte_run.decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            p = self.pieces[i]
            if p.type == BYTE:
                byte_run.append(int(p.piece[1:-1], 16))
                continue
            flush()
            if p.type in (CONTROL, UNKNOWN, UNUSED):
                continue
            parts.append(p.piece)
        flush()
        text = "".join(parts).replace(_WS, " ")
        if self.normalizer["add_dummy_prefix"] and text.startswith(" "):
            text = text[1:]
        return text
