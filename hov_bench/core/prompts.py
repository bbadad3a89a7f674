"""Request contents: EK100-style questions, tokenized by the program's
prompt builder (the conversation template and the word-level tokenizer the
eval CLI uses without a checkpoint)."""

from __future__ import annotations

import numpy as np

ACTIONS = ("open the fridge", "take the knife", "wash the cup", "cut the onion",
           "pour the water", "close the drawer", "stir the pan", "put down the plate",
           "pick up the sponge", "turn on the tap", "peel the carrot", "open the cupboard")


def ek_question(rng: np.random.Generator) -> str:
    from handsonvlm_torch.constants import ACTION_QUESTION_TEMPLATES

    template = ACTION_QUESTION_TEMPLATES[int(rng.integers(len(ACTION_QUESTION_TEMPLATES)))]
    return template.format(ACTIONS[int(rng.integers(len(ACTIONS)))])


def first_turn(engine, rng: np.random.Generator) -> np.ndarray:
    """The (1, T) ids of a first turn: the question with the clip."""
    return engine.build_prompt_ids(ek_question(rng))

