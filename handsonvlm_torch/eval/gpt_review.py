"""GPT-based pairwise answer review for RTL (reference:
lita/eval/{eval_gpt_review_rtl,summarize_gpt_review}.py).

A copy of `handsonvlm_tpu/eval/gpt_review.py`, which imports no JAX. The
judge-LLM call is injected: any callable `(system, user, max_tokens) ->
str` (a local judge, a test's fake); by default `openai_judge`, which
imports the `openai` package only when it is called, never at module
level. Prompt assembly, score parsing, resume semantics and summary math
match the reference.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

SYSTEM_PROMPT = (
    "You are a helpful and precise assistant for checking the quality of the answer."
)
NUM_SECONDS_TO_SLEEP = 0.5


def openai_judge(system: str, user: str, max_tokens: int, model: str = "gpt-4-0613") -> str:
    import openai  # imported on use: the package is optional

    while True:
        try:
            response = openai.ChatCompletion.create(
                model=model,
                messages=[
                    {"role": "system", "content": system},
                    {"role": "user", "content": user},
                ],
                max_tokens=max_tokens,
                temperature=0.2,
                request_timeout=60,
            )
            return response["choices"][0]["message"]["content"]
        except Exception as e:  # noqa: BLE001 — retry like the reference
            print(e)
            time.sleep(NUM_SECONDS_TO_SLEEP)


def parse_score(review: str) -> List[float]:
    """First line 'x, y' -> [x, y]; [-1,-1] on parse failure
    (eval_gpt_review_rtl.py:47-61)."""
    try:
        pair = review.split("\n")[0].replace(",", " ").split()
        if len(pair) == 2:
            return [float(pair[0]), float(pair[1])]
        print("error", review)
        return [-1, -1]
    except Exception as e:  # noqa: BLE001
        print(e)
        print("error", review)
        return [-1, -1]


def build_review_prompt(context: str, question: str, ans_gnd: str, ans_out: str, rule_prompt: str, role: str = "Assistant") -> str:
    return (
        f"[Context]\n{context}\n\n"
        f"[Question]\n{question}\n\n"
        f"[{role} 1]\n{ans_gnd}\n\n[End of {role} 1]\n\n"
        f"[{role} 2]\n{ans_out}\n\n[End of {role} 2]\n\n"
        f"[System]\n{rule_prompt}\n\n"
    )


def context_from_captions(captions: Dict) -> str:
    """Dense captions -> '<start> <end> sentence' context lines."""
    out = ""
    for i, (start, end) in enumerate(captions["timestamps"]):
        out += f"<{start}> <{end}> {captions['sentences'][i].strip()}\n"
    return out.strip()


def run_reviews(
    answers: Sequence[Dict],
    contexts: Dict,
    rule_prompt: str,
    output_path: str,
    judge: Optional[Callable[[str, str, int], str]] = None,
    max_tokens: int = 1024,
) -> List[Dict]:
    """Review each answer pair, appending jsonl; resumes from an existing
    output file like the reference."""
    judge = judge or openai_judge
    done = []
    if os.path.isfile(os.path.expanduser(output_path)):
        done = [json.loads(line) for line in open(os.path.expanduser(output_path))]
    results = list(done)
    with open(output_path, "a") as review_file:
        for idx, answer in enumerate(answers):
            if idx < len(done):
                continue
            vid = answer["question_id"][:11]
            context = context_from_captions(contexts["v_" + vid])
            content = build_review_prompt(
                context, answer["prompt"], answer["text_gnd"], answer["text_out"], rule_prompt
            )
            review = judge(SYSTEM_PROMPT, content, max_tokens)
            entry = {
                "id": idx + 1,
                "question_id": answer["question_id"],
                "answer_id": answer.get("answer_id"),
                "content": review,
                "tuple": parse_score(review),
            }
            review_file.write(json.dumps(entry) + "\n")
            review_file.flush()
            results.append(entry)
    return results


def summarize_reviews(review_entries: Sequence[Dict]) -> Dict[str, float]:
    """Relative score = 100 * model/gnd mean (summarize_gpt_review.py)."""
    scores = defaultdict(list)
    for review in review_entries:
        pair = review.get("tuple", [-1, -1])
        if pair[0] == -1:
            continue
        scores["gnd"].append(pair[0])
        scores["out"].append(pair[1])
    if not scores["gnd"]:
        return {"n": 0}
    gnd = sum(scores["gnd"]) / len(scores["gnd"])
    out = sum(scores["out"]) / len(scores["out"])
    return {
        "n": len(scores["gnd"]),
        "score_gnd": gnd,
        "score_out": out,
        "relative": 100.0 * out / gnd if gnd else float("nan"),
    }
