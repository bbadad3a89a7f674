"""Reasoning temporal localization (RTL) evaluation utilities.

Port of `handsonvlm_tpu/eval/rtl.py` (behavioral spec from
`lita/eval/eval_model_rtl.py:84-274`): parse the first two timestamps out
of generated text, clamp to [0, duration], order them, and score IoU /
Precision@0.5 against ground-truth segments. The time-token decode
direction (token id -> seconds) inverts the dataset quantization:
t_seconds = duration * token_index / (num_time_tokens - 1).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from handsonvlm_torch.constants import NUM_TIME_TOKENS

TIMESTAMP_PATTERN = re.compile(r"\<(?:(?:\d*\.\d+)|(?:\d+\.?))\>")


def time_token_to_seconds(token_index: int, duration: float, num_time_tokens: int = NUM_TIME_TOKENS) -> float:
    return duration * token_index / float(num_time_tokens - 1)


def decode_time_tokens(
    token_ids: Sequence[int],
    duration: float,
    time_token_ids: Sequence[int],
    num_time_tokens: int = NUM_TIME_TOKENS,
) -> Tuple[List[int], List[float]]:
    """Replace time-token ids with nothing, returning (other_ids, seconds).

    Mirrors the decode loop of eval_model_rtl.py:189-205: each time token in
    the output is converted back to seconds via the dataset quantization.
    """
    id_to_index = {tid: i for i, tid in enumerate(time_token_ids)}
    rest, seconds = [], []
    for tid in token_ids:
        tid = int(tid)
        if tid in id_to_index:
            seconds.append(time_token_to_seconds(id_to_index[tid], duration, num_time_tokens))
        else:
            rest.append(tid)
    return rest, seconds


def parse_start_end_timestamps(outputs: str, duration: float, strict: bool = False) -> Tuple[str, List[float]]:
    """Extract the first two <12.3>-style timestamps (eval_model_rtl.py:84-108)."""
    matches = list(TIMESTAMP_PATTERN.finditer(outputs))
    if strict:
        assert len(matches) >= 2, "cannot find timestamps"
    elif len(matches) < 2:
        return outputs, [0.0, duration]
    prev_end = 0
    sentence = ""
    timestamps = []
    for m in matches[:2]:
        timestamps.append(min(max(float(m.group(0)[1:-1]), 0.0), duration))
        sentence += outputs[prev_end : m.start(0)]
        prev_end = m.end(0)
    sentence += outputs[prev_end:]
    return sentence.strip(), [min(timestamps), max(timestamps)]


def iou(seg1: Sequence[float], seg2: Sequence[float]) -> float:
    assert seg1[1] >= seg1[0] and seg2[1] >= seg2[0]
    x1 = max(seg1[0], seg2[0])
    x2 = min(seg1[1], seg2[1])
    inter = max(x2 - x1, 0.0)
    union = max(seg1[1] - seg1[0], 0.0) + max(seg2[1] - seg2[0], 0.0) - inter
    return inter / union if union else 0.0


def precision_at(threshold: float):
    def precision(seg1, seg2) -> float:
        return float(iou(seg1, seg2) >= threshold)

    return precision


METRICS = {"iou": iou, "precision@0.5": precision_at(0.5)}


def score_rtl(predictions: Sequence[Dict]) -> Dict[str, float]:
    """predictions: [{'pred': [s,e], 'gt': [s,e], 'task': str?}] -> means
    per metric (and per task when tasks are given)."""
    agg: Dict[str, Dict[str, list]] = {m: defaultdict(list) for m in METRICS}
    for p in predictions:
        task = p.get("task", "all")
        for name, fn in METRICS.items():
            agg[name][task].append(fn(p["pred"], p["gt"]))
    out = {}
    for name, per_task in agg.items():
        vals = [v for values in per_task.values() for v in values]
        out[name] = sum(vals) / len(vals) if vals else float("nan")
        for task, values in per_task.items():
            if task != "all":
                out[f"{name}/{task}"] = sum(values) / len(values)
    return out
