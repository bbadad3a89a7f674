"""Tokenization: image-token splicing, SFT label masking, tokenizer setup.

Torch-free re-implementation of the reference's tokenization contract:
- `tokenizer_image_token` (llava/mm_utils.py:20-77): split on `<image>`,
  insert the -200 sentinel, drop duplicated BOS of later chunks.
- `preprocess_v1` (lita/dataset/base_dataset.py:183-255): vicuna-v1 prompt
  rendering + IGNORE_INDEX masking of system/human turns using the same
  split-on-sep2 / instruction_len-2 arithmetic (the arithmetic is part of
  the data contract — checkpoints were trained with these exact masks).
- tokenizer surgery (handsonvlm/model/builder.py:113-152,
  lita/model/lita_arch.py:88-94, handsonvlm_arch.py:19-25): 100 time tokens
  then `<hand_traj>` = 32100.

Any tokenizer with `encode(text) -> List[int]` (BOS included), plus
bos/eos/pad ids and `model_max_length`, works — the real path wraps the HF
Vicuna sentencepiece tokenizer; tests use the deterministic mock.
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence

import numpy as np

from handsonvlm_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    HAND_TOKEN_TEMPLATE,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    NUM_TIME_TOKENS,
    TIME_TOKEN_TEMPLATE,
)
from handsonvlm_torch.data.conversation import Conversation, SeparatorStyle, conv_templates


class Tokenizer(Protocol):
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    model_max_length: int

    def encode(self, text: str) -> List[int]:
        """Tokenize with BOS prepended (sentencepiece convention)."""
        ...


def tokenizer_image_token(
    prompt: str, tokenizer: Tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
) -> List[int]:
    """Split the prompt on <image> and insert the sentinel id."""
    chunks = [tokenizer.encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    def insert_separator(xs, sep):
        out = []
        for i, x in enumerate(xs):
            out.append(x)
            if i != len(xs) - 1:
                out.append(sep)
        return out

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    for x in insert_separator(chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])
    return input_ids


def build_conversation_prompt(
    source: Sequence[Dict[str, str]], conv: Conversation
) -> str:
    """Render a [{'from': 'human'|'gpt', 'value': ...}] source to a prompt."""
    conv = conv.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles[source[0]["from"]] != conv.roles[0]:
        source = source[1:]
    conv.messages = []
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], "conversation roles must alternate"
        conv.append_message(role, sentence["value"])
    return conv.get_prompt()


def preprocess_multimodal(sources):
    """Move <image> to its own leading line (epic_dataset.py:19-32)."""
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                v = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + v).strip()
    return sources


def preprocess_v1(
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer: Tokenizer,
    has_image: bool = False,
    conv: Conversation = None,
) -> Dict[str, np.ndarray]:
    """Vicuna-v1 SFT tokenization + label masking.

    Returns dict(input_ids (B,T) int64 right-padded with pad_token_id,
    labels (B,T) with IGNORE_INDEX over system/human/pad positions).
    """
    conv = conv or conv_templates["v1"]
    assert conv.sep_style == SeparatorStyle.TWO

    conversations = [build_conversation_prompt(s, conv) for s in sources]

    if has_image:
        ids_list = [tokenizer_image_token(p, tokenizer) for p in conversations]
    else:
        ids_list = [tokenizer.encode(p)[: tokenizer.model_max_length] for p in conversations]

    max_len = max(len(x) for x in ids_list)
    b = len(ids_list)
    input_ids = np.full((b, max_len), tokenizer.pad_token_id, np.int64)
    for i, ids in enumerate(ids_list):
        input_ids[i, : len(ids)] = ids
    targets = input_ids.copy()

    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target, ids in zip(conversations, targets, ids_list):
        total_len = len(ids)

        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if has_image:
                round_len = len(tokenizer_image_token(rou, tokenizer))
                instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) - 2
            else:
                round_len = len(tokenizer.encode(rou))
                instruction_len = len(tokenizer.encode(parts[0])) - 2
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX

        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX  # tokenization mismatch -> drop sample

    return {"input_ids": input_ids, "labels": targets}


def preprocess_plain(
    sources: Sequence[Sequence[Dict[str, str]]], tokenizer: Tokenizer
) -> Dict[str, np.ndarray]:
    """Projector-pretraining format (base_dataset.py:321-337): prompt is the
    bare <image> token; everything before the caption is masked."""
    ids_list, label_list = [], []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        prompt = DEFAULT_IMAGE_TOKEN + source[1]["value"] + "\n"
        ids = tokenizer_image_token(prompt, tokenizer)
        labels = list(ids)
        masked = len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))
        labels[:masked] = [IGNORE_INDEX] * masked
        ids_list.append(ids)
        label_list.append(labels)
    max_len = max(len(x) for x in ids_list)
    input_ids = np.full((len(ids_list), max_len), tokenizer.pad_token_id, np.int64)
    labels = np.full((len(ids_list), max_len), IGNORE_INDEX, np.int64)
    for i, (ids, lab) in enumerate(zip(ids_list, label_list)):
        input_ids[i, : len(ids)] = ids
        labels[i, : len(lab)] = lab
    return {"input_ids": input_ids, "labels": labels}


def preprocess_llama_2(
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer: Tokenizer,
    has_image: bool = False,
) -> Dict[str, np.ndarray]:
    """LLAMA_2 [INST] format (base_dataset.py:183-255 llama_2 variant):
    same split/offset arithmetic with sep '[/INST] ' and sep2 '</s>'."""
    conv = conv_templates["llama_2"]
    conversations = [build_conversation_prompt(s, conv) for s in sources]
    if has_image:
        ids_list = [tokenizer_image_token(p, tokenizer) for p in conversations]
    else:
        ids_list = [tokenizer.encode(p)[: tokenizer.model_max_length] for p in conversations]
    max_len = max(len(x) for x in ids_list)
    b = len(ids_list)
    input_ids = np.full((b, max_len), tokenizer.pad_token_id, np.int64)
    for i, ids in enumerate(ids_list):
        input_ids[i, : len(ids)] = ids
    targets = input_ids.copy()

    sep = "[/INST] "
    for conversation, target, ids in zip(conversations, targets, ids_list):
        total_len = len(ids)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if has_image:
                round_len = len(tokenizer_image_token(rou, tokenizer))
                instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) - 2
            else:
                round_len = len(tokenizer.encode(rou))
                instruction_len = len(tokenizer.encode(parts[0])) - 2
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def preprocess(
    sources, tokenizer: Tokenizer, has_image: bool = False, conv: Conversation = None
) -> Dict[str, np.ndarray]:
    """Dispatch on the conversation style (base_dataset.py:340-355)."""
    conv = conv or conv_templates["v1"]
    if conv.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if conv.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image, conv)
    raise NotImplementedError(f"unsupported conversation style {conv.version}")


# ---------------------------------------------------------------------------
# HF tokenizer wrapper (the real path; requires a local Vicuna tokenizer)
# ---------------------------------------------------------------------------


class SpmHFShim:
    """HF-slow-tokenizer-shaped facade over the pure-python sentencepiece
    loader (data/spm_model.py). Exists so a checkpoint shipping ONLY a
    `tokenizer.model` file is loadable with zero dependencies (the
    `sentencepiece` package is absent in this environment and the fast
    tokenizer needs tokenizer.json). Mirrors the slow LlamaTokenizer's
    legacy behavior the reference ran on (transformers 4.31,
    builder.py:89 use_fast=False): BOS prepended once, text split on added
    tokens with each chunk sentencepiece-encoded independently (so each
    chunk gets the dummy prefix — the documented 'legacy' semantics)."""

    def __init__(self, model_file: str, model_max_length: int = 2048):
        import re

        from handsonvlm_torch.data.spm_model import SentencePieceModel

        self._re = re
        self.sp = SentencePieceModel.load(model_file)
        self.bos_token_id = self.sp.bos_id if self.sp.bos_id >= 0 else None
        self.eos_token_id = self.sp.eos_id if self.sp.eos_id >= 0 else None
        self.pad_token_id = self.sp.pad_id if self.sp.pad_id >= 0 else None
        self.unk_token_id = self.sp.unk_id
        self.model_max_length = model_max_length
        self._added: Dict[str, int] = {}
        self._added_ids: Dict[int, str] = {}
        # HF treats unk/bos/eos(/pad) as special tokens that are split out
        # of the text and mapped to their ids BEFORE sentencepiece runs
        # (spm itself never matches CONTROL pieces from text) — the
        # preprocess_v1 masking arithmetic depends on '</s>' encoding as
        # exactly one token
        self._split_tokens: Dict[str, int] = {}
        for i in (self.sp.unk_id, self.sp.bos_id, self.sp.eos_id, self.sp.pad_id):
            if i is not None and 0 <= i < self.sp.vocab_size():
                self._split_tokens[self.sp.id_to_piece(i)] = i
        self._split = None
        self._rebuild_split_re()

    def _rebuild_split_re(self):
        toks = {**self._split_tokens, **self._added}
        if toks:
            pat = "|".join(
                self._re.escape(t) for t in sorted(toks, key=len, reverse=True)
            )
            self._split = self._re.compile(f"({pat})")
        self._split_ids = toks

    def __len__(self):
        return self.sp.vocab_size() + len(self._added)

    def add_tokens(self, tokens) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        n = 0
        for t in tokens:
            if t in self._added or t in self.sp._piece_to_id:
                continue
            idx = self.sp.vocab_size() + len(self._added)
            self._added[t] = idx
            self._added_ids[idx] = t
            n += 1
        self._rebuild_split_re()
        return n

    def convert_tokens_to_ids(self, tokens):
        single = isinstance(tokens, str)
        ts = [tokens] if single else tokens
        out = [self._added.get(t, self.sp.piece_to_id(t)) for t in ts]
        return out[0] if single else out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        if self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        chunks = self._split.split(text) if self._split else [text]
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self._split_ids:
                ids.append(self._split_ids[chunk])
            else:
                ids.extend(self.sp.encode(chunk))
        return ids

    class _Encoding:
        def __init__(self, input_ids):
            self.input_ids = input_ids

    def __call__(self, text: str):
        return self._Encoding(self.encode(text))

    def decode(self, ids) -> str:
        # HF-style: sub-sequences between added tokens decode via spm and
        # join with single spaces around the added-token strings
        segs: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                segs.append(self.sp.decode(run))
                run.clear()

        for i in ids:
            i = int(i)
            if i in self._added_ids:
                flush()
                segs.append(self._added_ids[i])
            else:
                run.append(i)
        flush()
        return " ".join(s for s in segs if s)


class HFTokenizer:
    """Wraps a transformers LlamaTokenizer with the HandsOnVLM vocab surgery.

    `path` may also point directly at a sentencepiece `tokenizer.model`
    file (or a directory containing only one): those load through the
    dependency-free pure-python backend (SpmHFShim)."""

    def __init__(self, path: str, model_max_length: int = 2048):
        import os

        import transformers

        spm_file = None
        if path.endswith(".model") and os.path.isfile(path):
            spm_file = path
        elif os.path.isdir(path):
            # a checkpoint dir shipping ONLY tokenizer.model (no
            # tokenizer_config.json/tokenizer.json) can't go through
            # AutoTokenizer at all — route straight to the pure-python
            # backend instead of failing in AutoConfig
            model_file = os.path.join(path, "tokenizer.model")
            has_hf_files = any(
                os.path.isfile(os.path.join(path, f))
                for f in ("tokenizer_config.json", "tokenizer.json")
            )
            if os.path.isfile(model_file) and not has_hf_files:
                spm_file = model_file
        if spm_file is not None:
            self.tok = SpmHFShim(spm_file, model_max_length)
        else:
            try:
                # the reference loads the slow sentencepiece tokenizer
                # (builder.py:89 use_fast=False); environments without the
                # sentencepiece package (this repo's CI) fall back to the fast
                # tokenizer, which produces identical ids from the same vocab
                self.tok = transformers.AutoTokenizer.from_pretrained(
                    path, use_fast=False
                )
            except Exception as e:
                # scope the fallback to the documented missing-sentencepiece
                # case; anything else (bad path, corrupt files) should surface
                if not isinstance(e, (ImportError, ModuleNotFoundError)) and \
                        "sentencepiece" not in str(e).lower():
                    raise
                import logging

                try:
                    self.tok = transformers.AutoTokenizer.from_pretrained(
                        path, use_fast=True
                    )
                    logging.getLogger(__name__).warning(
                        "slow tokenizer load failed (%s); fell back to "
                        "use_fast=True", e
                    )
                except Exception:
                    # no fast files either: a bare tokenizer.model in the
                    # checkpoint dir loads through the pure-python backend
                    model_file = os.path.join(path, "tokenizer.model")
                    if not os.path.isfile(model_file):
                        raise
                    logging.getLogger(__name__).warning(
                        "transformers load failed (%s); loading %s with the "
                        "pure-python sentencepiece backend", e, model_file
                    )
                    self.tok = SpmHFShim(model_file, model_max_length)
        self.tok.model_max_length = model_max_length
        self.model_max_length = model_max_length
        # tokenizer surgery, replaying builder.py:113-152
        time_tokens = [TIME_TOKEN_TEMPLATE.format(t=x) for x in range(NUM_TIME_TOKENS)]
        self.tok.add_tokens(time_tokens)
        self.tok.add_tokens([HAND_TOKEN_TEMPLATE])
        self.time_token_ids = self.tok.convert_tokens_to_ids(time_tokens)
        self.hand_token_id = self.tok.convert_tokens_to_ids(HAND_TOKEN_TEMPLATE)
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id
        self.pad_token_id = (
            self.tok.pad_token_id if self.tok.pad_token_id is not None else self.tok.unk_token_id
        )

    def __len__(self):
        return len(self.tok)

    def add_pixel_tokens(self, n_bins: int) -> List[int]:
        """<bin_1>..<bin_n> tokens (handsonvlm_arch.py:27-31; unused by the
        default recipe but part of the tokenizer surface)."""
        bin_tokens = [f"<bin_{i}>" for i in range(1, n_bins + 1)]
        self.tok.add_tokens(bin_tokens)
        return self.tok.convert_tokens_to_ids(bin_tokens)

    def encode(self, text: str) -> List[int]:
        return self.tok(text).input_ids

    def decode(self, ids) -> str:
        return self.tok.decode(ids)
