"""Conversation templates.

Behavioral spec from `llava/conversation.py` (reference): the prompt string
layout is part of the checkpoint contract (the SFT data was rendered with
these exact separators). Only the template styles actually reachable from
the HandsOnVLM/LITA stack are kept: TWO (vicuna v1 — the shipped default),
SINGLE (v0), PLAIN (projector pretraining), LLAMA_2.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = "single"
    TWO = "two"
    PLAIN = "plain"
    LLAMA_2 = "llama_2"


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "unknown"

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[list(m) for m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            wrap_sys = lambda msg: f"<<SYS>>\n{msg}\n<</SYS>>\n\n"
            wrap_inst = lambda msg: f"[INST] {msg} [/INST]"
            ret = ""
            for i, (role, message) in enumerate(self.messages):
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        raise ValueError(self.sep_style)


conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_vicuna_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="\n",
    version="plain",
)

conv_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. You are able to "
        "understand the visual content that the user provides, and assist "
        "the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_templates = {
    "default": conv_vicuna_v1,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "plain": conv_llava_plain,
    "llama_2": conv_llama_2,
}

default_conversation = conv_vicuna_v1
