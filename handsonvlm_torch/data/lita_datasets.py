"""LITA task datasets: dense video captioning, event localization, video QA,
temporal reasoning, image instruction.

Port of `handsonvlm_tpu/data/lita_datasets.py` (behavioral spec from
`lita/dataset/{dvc_dataset,event_loc_dataset,vidqa_dataset,
temporal_reasoning_dataset,instruct_dataset}.py`): the JSON layouts,
prompt pools, timestamp -> <t{i}> conversion (t = round((num_time_tokens-1)
* timestamp / duration)) and the random-index __getitem__ with
resample-on-error are all preserved so the reference's prepared data
directories drop in unchanged. Each dataset
draws from the generators it is given: `rng` (a `random.Random`: prompts)
and `np_rng` (a `np.random.Generator`: item and segment indices), never
from the global ones. Frames are read without the /dev/shm cache.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import random
import re
from typing import Dict, List, Optional

import numpy as np

from handsonvlm_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    NUM_FRAMES,
    NUM_TIME_TOKENS,
    TIME_TOKEN_TEMPLATE,
)
from handsonvlm_torch.data.tokenization import (
    preprocess_multimodal,
    preprocess_plain,
    preprocess_v1,
)
from handsonvlm_torch.data.video_io import load_image, load_video, load_video_frames


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def timestamp_to_time_token(t: float, duration: float, num_time_tokens: int = NUM_TIME_TOKENS) -> str:
    """DVC/event-loc timestamp quantization (dvc_dataset.py:74-81)."""
    max_offset = float(num_time_tokens - 1)
    idx = int(np.round(max_offset * (float(t) / float(duration))))
    return TIME_TOKEN_TEMPLATE.format(t=idx)


TIMESTAMP_PATTERN = re.compile(
    r"\<(?:(?:\d*\.\d+)|(?:\d+\.?))\>"
)


def convert_timestamps_to_time_tokens(answer: str, duration: float, num_time_tokens: int = NUM_TIME_TOKENS) -> str:
    """<12.5> -> <t{...}> (temporal_reasoning_dataset.py:60-80)."""
    out = []
    prev = 0
    for m in TIMESTAMP_PATTERN.finditer(answer):
        ts = float(m.group(0)[1:-1])
        out.append(answer[prev : m.start(0)])
        out.append(timestamp_to_time_token(ts, duration, num_time_tokens))
        prev = m.end(0)
    out.append(answer[prev:])
    return "".join(out)


class LitaBaseDataset:
    """Random-index dataset with resample-on-error (base_dataset.py:385-456)."""

    num_frames = NUM_FRAMES
    num_time_tokens = NUM_TIME_TOKENS
    image_size = 224

    def __init__(self, data_path: str, tokenizer, load_images: bool = True,
                 rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.Generator] = None):
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = np_rng if np_rng is not None else np.random.default_rng(0)
        self.data_path = data_path
        self.tokenizer = tokenizer
        self.load_images = load_images
        self.set_params()
        self.list_data_dict: List[Dict] = []
        self.init_list_data_dict()

    def set_params(self):
        pass

    def init_list_data_dict(self):
        pass

    def get_sources(self, i: int) -> Dict:
        raise NotImplementedError

    def get_visual(self, sources: Dict) -> np.ndarray:
        raise NotImplementedError

    def __len__(self):
        return len(self.list_data_dict)

    def route_draws(self, rng, np_rng) -> None:
        """Draw from `rng` / `np_rng` from now on (data/draws.seed_mixture)."""
        self.rng, self.np_rng = rng, np_rng

    def _frames_for_vid(self, vid: str) -> List[str]:
        frames = sorted(glob.glob(os.path.join(self.image_folder, vid, "*" + self.ext)))
        idx = np.round(np.linspace(0, len(frames) - 1, self.num_frames)).astype(int)
        return list(np.asarray(frames)[idx])

    def __getitem__(self, _: int) -> Dict:
        i = int(self.np_rng.integers(0, len(self.list_data_dict)))
        sources = self.get_sources(i)
        has_image = "image" in sources
        if has_image and self.load_images:
            try:
                image = self.get_visual(sources)
            except Exception as e:  # noqa: BLE001 — resample like the reference
                print(f"visual load failed ({e}); resampling")
                return self[0]
        elif has_image:
            image = np.zeros((self.num_frames, 3, self.image_size, self.image_size), np.float32)
        else:
            image = np.zeros((3, self.image_size, self.image_size), np.float32)
        convo = preprocess_multimodal(copy.deepcopy([sources["conversations"]]))
        tok = preprocess_v1(convo, self.tokenizer, has_image=has_image)
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": image,
        }


# ---------------------------------------------------------------------------
# Dense video captioning (dvc_dataset.py)
# ---------------------------------------------------------------------------


class DVCDataset(LitaBaseDataset):
    desc_prompts = [
        "Provide a detailed description of the given video.",
        "Describe the provided video in detail.",
        "Summarize the visual content of the video.",
        "Write a informative summary of the video.",
    ]
    time_prompts = [
        "Each sentence should begin with the start and end timestamps.",
        "At the beginning of each sentence, include the start and end timestamps.",
        "Prepend each sentence with its start and end timestamps.",
    ]
    visual_data_type = "video_frames"
    ext = ".jpg"

    def get_prompt(self) -> str:
        task = self.rng.choice(self.desc_prompts) + " " + self.rng.choice(self.time_prompts)
        return DEFAULT_IMAGE_TOKEN + "\n" + task

    def get_sources(self, i: int) -> Dict:
        captions = self.list_data_dict[i]
        out = {"id": captions["id"]}
        if self.visual_data_type == "video_frames":
            out["image"] = self._frames_for_vid(captions["id"])
        else:
            out["image"] = os.path.join(self.image_folder, captions["image"])
        duration = captions["duration"]
        gpt_value = ""
        for k, (start, end) in enumerate(captions["timestamps"]):
            st = timestamp_to_time_token(start, duration, self.num_time_tokens)
            et = timestamp_to_time_token(end, duration, self.num_time_tokens)
            gpt_value += f"{st} {et} {captions['sentences'][k].strip()} "
        out["conversations"] = [
            {"from": "human", "value": self.get_prompt()},
            {"from": "gpt", "value": gpt_value.strip()},
        ]
        return out

    def get_visual(self, sources):
        if self.visual_data_type == "video_frames":
            return load_video_frames(sources["image"])
        return load_video(sources["image"], self.num_frames)

    def _load_json_dict(self, path, require_frames=False):
        data = _load_json(path)
        for k, v in data.items():
            v["id"] = k
            if require_frames and not os.path.exists(os.path.join(self.image_folder, k)):
                continue
            self.list_data_dict.append(v)


class DVCDataset_activitynet(DVCDataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "activitynet-captions", "activitynet_frames")

    def init_list_data_dict(self):
        self._load_json_dict(os.path.join(self.data_path, "activitynet-captions", "train.json"))


class DVCDataset_youcook2(DVCDataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "youcook2", "youcook2_frames")

    def init_list_data_dict(self):
        self._load_json_dict(
            os.path.join(self.data_path, "VidChapters", "YouCook2", "train.json"),
            require_frames=True,
        )


class DVCDataset_vitt(DVCDataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "vitt", "vitt_frames")

    def init_list_data_dict(self):
        self._load_json_dict(
            os.path.join(self.data_path, "VidChapters", "ViTT", "train.json"),
            require_frames=True,
        )


class DVCDataset_howto100m(DVCDataset):
    visual_data_type = "video"

    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "howto100m", "raw_videos")

    def init_list_data_dict(self):
        self._load_json_dict(os.path.join(self.data_path, "howto100m", "howto100m_dvc_filter_25.json"))


# ---------------------------------------------------------------------------
# Event localization (event_loc_dataset.py)
# ---------------------------------------------------------------------------


class EventLocDataset(DVCDataset):
    desc_prompts = [
        'When does "%s" happen in the video?',
        'At what point in the video does "%s" happen?',
        'When is "%s" depicted in the video?',
        'At what time in the video does "%s" take place?',
    ]
    time_prompts = [
        "Answer the question only using start and end timestamps.",
        "Provide a response using only start and end timestamps.",
        "Convey your answer using start and end timestamps exclusively.",
    ]

    def get_prompt(self, sentence: str) -> str:
        desc = self.rng.choice(self.desc_prompts)
        time = self.rng.choice(self.time_prompts)
        sentence = sentence.strip().rstrip(".")
        if len(sentence) > 1:
            sentence = sentence[0].lower() + sentence[1:]
        return DEFAULT_IMAGE_TOKEN + "\n" + (desc % sentence) + " " + time

    def get_sources(self, i: int) -> Dict:
        captions = self.list_data_dict[i]
        out = {"id": captions["id"], "image": self._frames_for_vid(captions["id"])}
        k = int(self.np_rng.integers(0, len(captions["timestamps"])))
        duration = captions["duration"]
        start, end = captions["timestamps"][k]
        st = timestamp_to_time_token(start, duration, self.num_time_tokens)
        et = timestamp_to_time_token(end, duration, self.num_time_tokens)
        out["conversations"] = [
            {"from": "human", "value": self.get_prompt(captions["sentences"][k]).strip()},
            {"from": "gpt", "value": f"{st} {et}"},
        ]
        return out


class EventLocDataset_activitynet(EventLocDataset, DVCDataset_activitynet):
    pass


class EventLocDataset_youcook2(EventLocDataset, DVCDataset_youcook2):
    pass


class EventLocDataset_vitt(EventLocDataset, DVCDataset_vitt):
    pass


# ---------------------------------------------------------------------------
# Video QA (vidqa_dataset.py)
# ---------------------------------------------------------------------------


class VidQADataset(LitaBaseDataset):
    task_prompt = "Answer the question using a single word or phrase."
    visual_data_type = "video"

    def get_sources(self, i: int) -> Dict:
        vqas = self.list_data_dict[i]
        out = {"image": os.path.join(self.image_folder, vqas["video"])}
        convo = []
        for k, vqa in enumerate(vqas["QA"]):
            prompt = DEFAULT_IMAGE_TOKEN + "\n" if k == 0 else ""
            q = vqa["q"].strip()
            if len(q) > 1:
                q = q[0].upper() + q[1:]
            if self.task_prompt and not q.endswith("?"):
                q += "?"
            prompt += q + " " + self.task_prompt
            convo.append({"from": "human", "value": prompt.strip()})
            convo.append({"from": "gpt", "value": vqa["a"].strip()})
        out["conversations"] = convo
        return out

    def get_visual(self, sources):
        return load_video(sources["image"], self.num_frames)

    def _load_json_list(self, path):
        self.list_data_dict = _load_json(path)


class VidQADataset_msvdqa(VidQADataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "msvdqa", "YouTubeClips")

    def init_list_data_dict(self):
        self._load_json_list(os.path.join(self.data_path, "msvdqa", "train_qa.json"))


class VidQADataset_msrvttqa(VidQADataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "msrvttqa", "TrainValVideo")

    def init_list_data_dict(self):
        self._load_json_list(os.path.join(self.data_path, "msrvttqa", "train_qa.json"))


class VidQADataset_nextqa(VidQADataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "nextqa", "NExTVideo")

    def init_list_data_dict(self):
        self._load_json_list(os.path.join(self.data_path, "nextqa", "train.json"))


class VidQADataset_videochat(VidQADataset):
    task_prompt = ""

    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "videochat_instruct_11k", "videos")

    def init_list_data_dict(self):
        self._load_json_list(os.path.join(self.data_path, "videochat_instruct_11k", "videochat_instruct_11k.json"))


# ---------------------------------------------------------------------------
# Temporal reasoning (temporal_reasoning_dataset.py)
# ---------------------------------------------------------------------------


class TemporalReasoningDataset(LitaBaseDataset):
    visual_data_type = "video_frames"
    ext = ".jpg"

    def get_sources(self, i: int) -> Dict:
        vqas = self.list_data_dict[i]
        out = {"id": vqas["id"], "image": self._frames_for_vid(vqas["id"])}
        convo = []
        duration = vqas["duration"]
        for k, vqa in enumerate(vqas["QA"]):
            prompt = DEFAULT_IMAGE_TOKEN + "\n" if k == 0 else ""
            prompt += vqa["q"].strip()
            answer = convert_timestamps_to_time_tokens(vqa["a"], duration, self.num_time_tokens)
            convo.append({"from": "human", "value": prompt.strip()})
            convo.append({"from": "gpt", "value": answer.strip()})
        out["conversations"] = convo
        return out

    def get_visual(self, sources):
        return load_video_frames(sources["image"])


class TemporalReasoningDataset_activitynet(TemporalReasoningDataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "activitynet-captions", "activitynet_frames")

    def init_list_data_dict(self):
        self.list_data_dict = []
        path = os.path.join(
            self.data_path, "temporal_reasoning",
            "activitynet_train_gpt-4-0613_temp_6_f10009.json",
        )
        data = _load_json(path)
        for vid, d in data.items():
            for vqa in d["QA"]:
                self.list_data_dict.append({"id": vid, "duration": d["duration"], "QA": [vqa]})


# ---------------------------------------------------------------------------
# Image instruction (instruct_dataset.py LlavaDataset)
# ---------------------------------------------------------------------------


class LlavaDataset(LitaBaseDataset):
    def set_params(self):
        self.image_folder = os.path.join(self.data_path, "coco", "train2017")

    def init_list_data_dict(self):
        path = os.path.join(self.data_path, "LLaVA-Instruct-150K", "llava_instruct_150k.json")
        self.list_data_dict = _load_json(path)

    def get_sources(self, i: int) -> Dict:
        return self.list_data_dict[i]

    def get_visual(self, sources):
        img = load_image(os.path.join(self.image_folder, sources["image"]), cache_dir=None)
        # single image repeated num_frames x (instruct_dataset.py:37-41)
        return np.tile(img[None], (self.num_frames, 1, 1, 1))


class LlavaPretrainDataset(LitaBaseDataset):
    """Projector-pretraining dataset (llava/train/train.py
    LazySupervisedDataset with the plain conversation template): image +
    caption pairs, everything before the caption masked."""

    def __init__(self, data_path: str, tokenizer, load_images: bool = True,
                 json_name: str = "blip_laion_cc_sbu_558k.json",
                 image_subdir: str = "LLaVA-Pretrain/images", rng=None, np_rng=None):
        self.json_name = json_name
        self.image_subdir = image_subdir
        super().__init__(data_path, tokenizer, load_images, rng=rng, np_rng=np_rng)

    def set_params(self):
        self.image_folder = os.path.join(self.data_path, self.image_subdir)

    def init_list_data_dict(self):
        path = os.path.join(self.data_path, "LLaVA-Pretrain", self.json_name)
        self.list_data_dict = _load_json(path)

    def get_sources(self, i: int) -> Dict:
        return self.list_data_dict[i]

    def get_visual(self, sources):
        return load_image(os.path.join(self.image_folder, sources["image"]), cache_dir=None)

    def __getitem__(self, _: int) -> Dict:
        i = int(self.np_rng.integers(0, len(self.list_data_dict)))
        sources = self.get_sources(i)
        if self.load_images:
            try:
                image = self.get_visual(sources)
            except Exception as e:  # noqa: BLE001
                print(f"visual load failed ({e}); resampling")
                return self[0]
        else:
            image = np.zeros((3, self.image_size, self.image_size), np.float32)
        tok = preprocess_plain(
            copy.deepcopy([sources["conversations"]]), self.tokenizer
        )
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": image,
        }


LITA_DATASET_REGISTRY = {
    "dvc": {
        "activitynet": DVCDataset_activitynet,
        "youcook2": DVCDataset_youcook2,
        "vitt": DVCDataset_vitt,
        "howto100m": DVCDataset_howto100m,
    },
    "event_loc": {
        "activitynet": EventLocDataset_activitynet,
        "youcook2": EventLocDataset_youcook2,
        "vitt": EventLocDataset_vitt,
    },
    "imgqa": {"llava": LlavaDataset},
    "vidqa": {
        "msrvttqa": VidQADataset_msrvttqa,
        "msvdqa": VidQADataset_msvdqa,
        "nextqa": VidQADataset_nextqa,
        "videochat": VidQADataset_videochat,
    },
    "temporal_reasoning": {"activitynet": TemporalReasoningDataset_activitynet},
}
