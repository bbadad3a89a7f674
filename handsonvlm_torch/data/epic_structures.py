"""EPIC-KITCHENS dataset structures.

Port of `handsonvlm_tpu/data/epic_structures.py` (behavioral spec from
`hoi_forecast/dataset/epic_structures.py:18-489`): action validity
(start_time - t_ant >= 0), uid-keyed label preloading with an .npy cache,
lmdb per-frame TSN features with absent-hand defaults, (5,10,1024) feat /
(4,10,4) bbox / (5,10) valid tensors, and the eval variant backed by the
amazon-annotated label pkl. Annotation rows come as
data/annotation.py's `Table`; draws come from the `random.Random` the
dataset is given (narration rephrasing, wrong-narration sampling) and the
`np.random.Generator` it is given (the labels' contact points and the
conversation datasets' training indices), never from the global `random`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from handsonvlm_torch.data import epic_constants as C
from handsonvlm_torch.data.action_sampler import sample_history_frames
from handsonvlm_torch.data.annotation import Table
from handsonvlm_torch.data.epic_utils import process_eval_video_info, process_video_info
from handsonvlm_torch.data.video_io import load_video_frames


@dataclasses.dataclass
class EpicAction:
    uid: int
    participant_id: str
    video_id: str
    start_frame: int
    stop_frame: int
    start_time: float
    stop_time: float
    partition: str
    verb: Optional[str] = None
    verb_class: Optional[int] = None
    noun: Optional[str] = None
    noun_class: Optional[int] = None
    all_nouns: Optional[list] = None
    all_noun_classes: Optional[list] = None
    action: Optional[str] = None
    action_class: Optional[int] = None
    narration: Optional[str] = None

    @property
    def duration(self) -> float:
        return self.stop_time - self.start_time


def actions_from_df(df: Table, partition: str, t_ant: float = C.ANTICIPATION_SECONDS):
    """Split rows into (valid, invalid) actions like EpicVideo.get_actions
    (epic_structures.py:28-62): valid iff start_time - t_ant >= 0."""
    is_test = "test" in partition
    actions, invalid = [], []
    for _, row in df.iterrows():
        a = EpicAction(
            uid=row.uid,
            participant_id=row.participant_id,
            video_id=row.video_id,
            start_frame=row.start_frame,
            stop_frame=row.stop_frame,
            start_time=row.start_time,
            stop_time=row.stop_time,
            partition=partition,
            verb=None if is_test else row.verb,
            verb_class=None if is_test else row.verb_class,
            noun=None if is_test else row.noun,
            noun_class=None if is_test else row.noun_class,
            all_nouns=None if is_test else row.all_nouns,
            all_noun_classes=None if is_test else row.all_noun_classes,
            action=None if is_test else row.action,
            action_class=None if is_test else row.action_class,
            narration=None if is_test else getattr(row, "narration", None),
        )
        (actions if a.start_time - t_ant >= 0 else invalid).append(a)
    return actions, invalid


def _open_lmdb(path: str):
    """lmdbdict if available, else raw lmdb, else the native C++ reader
    (data/native_lmdb.py, for machines without liblmdb)."""
    try:
        from lmdbdict import lmdbdict

        return lmdbdict(path, "r")
    except ImportError:
        pass
    try:
        import lmdb  # may also be absent
    except ImportError:
        from handsonvlm_torch.data.native_lmdb import NativeLmdbDict

        return NativeLmdbDict(path)

    env = lmdb.open(path, readonly=True, lock=False, subdir=os.path.isdir(path))

    class _LmdbView:
        def __init__(self, env):
            self.env = env

        def __contains__(self, key: bytes) -> bool:
            with self.env.begin() as txn:
                return txn.get(key) is not None

        def __getitem__(self, key: bytes):
            with self.env.begin() as txn:
                buf = txn.get(key)
            if buf is None:
                raise KeyError(key)
            return pickle.loads(buf)

    return _LmdbView(env)


class EpicHOIDataset:
    """Training/validation dataset over labeled EK actions.

    __getitem__ returns the reference's hoi_feature_dict: feat (5,10,1024),
    bbox_feat (4,10,4), valid_mask (5,10), future_hands (2,5,2),
    contact_point (2,), future_valid (2,), image (10,3,224,224) float32,
    narration (rephrase-rate aware), names/paths. `rng` (default
    `random.Random(0)`) makes the narration and template draws, `np_rng`
    (default `np.random.default_rng(0)`) the labels' contact points and
    the training indices.
    """

    def __init__(
        self,
        df: Table,
        split: str,
        ek_version: str,
        load_images: bool = True,
        rephrase_rate: float = 0.0,
        use_wrong_narration: bool = False,
        use_percentage: float = 1.0,
        lmdb_env=None,
        labels: Optional[Dict] = None,
        rng: Optional[random.Random] = None,
        np_rng: Optional[np.random.Generator] = None,
    ):
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = np_rng if np_rng is not None else np.random.default_rng(0)
        self.split = split
        self.ek_version = ek_version
        self.load_images = load_images
        self.rephrase_rate = rephrase_rate
        self.use_wrong_narration = use_wrong_narration

        self.actions, self.actions_invalid = actions_from_df(df, split)
        self.labels = labels if labels is not None else self._load_labels()

        filtered = [a for a in self.actions if a.uid in self.labels]
        filtered.sort(key=lambda a: a.uid)
        if 0.0 < use_percentage < 1.0:
            filtered = filtered[: int(len(filtered) * use_percentage)]
        elif use_percentage == 0:
            filtered = filtered[:1]
        self.actions = filtered

        self.env = lmdb_env if lmdb_env is not None else _open_lmdb(C.lmdb_path(ek_version))

    # -- labels ------------------------------------------------------------

    def _load_labels(self) -> Dict[int, Dict]:
        cache = os.path.join(
            C.label_cache_dir(self.ek_version),
            f"{self.ek_version}_{self.split}_labels.npy",
        )
        if os.path.exists(cache):
            return np.load(cache, allow_pickle=True).item()
        ldir = C.label_dir(self.ek_version)
        labels: Dict[int, Dict] = {}
        for filename in sorted(os.listdir(ldir)):
            if not (filename.startswith("label_") and filename.endswith(".pkl")):
                continue
            uid = int(filename[6:-4].strip())
            try:
                with open(os.path.join(ldir, filename), "rb") as f:
                    video_info = pickle.load(f)
                fh, cp, fv, _ = process_video_info(video_info, self.np_rng)
                labels[uid] = {
                    "future_hands": fh,
                    "contact_point": cp,
                    "future_valid": fv,
                }
            except Exception as e:  # noqa: BLE001 — skip corrupt labels like the reference
                print(f"error loading label {filename}: {e}")
        try:
            np.save(cache, labels)  # cache for subsequent runs
        except OSError:
            pass
        return labels

    # -- frames / features ---------------------------------------------------

    def _frame_names(self, action: EpicAction) -> Tuple[np.ndarray, List[str]]:
        times, idxs = sample_history_frames(action.start_frame)
        names = [C.FRAME_TEMPLATE.format(i) for i in idxs]
        start = len(idxs) - C.OBSERVATION_FRAMES_NUM
        return times, names[start:]

    def load_image_paths(self, action: EpicAction) -> List[str]:
        _, names = self._frame_names(action)
        return [
            os.path.join(action.participant_id, "rgb_frames", action.video_id, n)
            for n in names
        ]

    def load_hoi_features(self, action: EpicAction) -> Dict:
        _, names = self._frame_names(action)
        times, idxs = sample_history_frames(action.start_frame)

        full_names, abs_paths = [], []
        feats = {k: [] for k in ("g", "rh", "lh", "ro", "lo")}
        masks = {k: [] for k in ("g", "rh", "lh", "ro", "lo")}
        bboxes = {k: [] for k in ("rh", "lh", "ro", "lo")}

        for name in names:
            full = os.path.join(action.participant_id, "rgb_frames", action.video_id, name)
            full_names.append(full)
            abs_paths.append(os.path.join(C.epic_kitchen_dataset_dir(), full))
            key = full.strip().encode()
            if key not in self.env:
                raise KeyError(f"invalid lmdb key {full}")
            d = self.env[key]

            g = d["GLOBAL_FEAT"]
            feats["g"].append(g)
            masks["g"].append(1)
            for fk, mk, feat_key in (
                ("rh", "rh", "HAND_RIGHT_FEAT"),
                ("lh", "lh", "HAND_LEFT_FEAT"),
                ("ro", "ro", "OBJECT_RIGHT_FEAT"),
                ("lo", "lo", "OBJECT_LEFT_FEAT"),
            ):
                feats[fk].append(d.get(feat_key, np.zeros_like(g, dtype=np.float32)))

            def hand_bbox(which, default_cx):
                key_ = f"HAND_{which}_BBOX"
                if key_ in d:
                    return d[key_], 1
                cx, cy, sx, sy = default_cx, 1.5, 0.1, 0.1
                return np.asarray([cx - sx / 2, cy - sy / 2, cx + sx / 2, cy + sy / 2]), 0

            def obj_bbox(which):
                key_ = f"OBJECT_{which}_BBOX"
                if key_ in d:
                    return d[key_], 1
                return np.asarray([0.0, 0.0, 1.0, 1.0]), 0

            for k, (bb, m) in (
                ("rh", hand_bbox("RIGHT", 0.75)),
                ("lh", hand_bbox("LEFT", 0.25)),
                ("ro", obj_bbox("RIGHT")),
                ("lo", obj_bbox("LEFT")),
            ):
                bboxes[k].append(bb)
                if k != "g":
                    masks[k].append(m)

        feat = np.stack(
            [np.stack(feats[k], 0) for k in ("g", "rh", "lh", "ro", "lo")], axis=0
        )
        bbox_feat = np.stack(
            [np.stack(bboxes[k], 0) for k in ("rh", "lh", "ro", "lo")], axis=0
        )
        valid_mask = np.stack(
            [np.asarray(masks[k]) for k in ("g", "rh", "lh", "ro", "lo")], axis=0
        )
        assert feat.shape == (5, C.OBSERVATION_FRAMES_NUM, 1024), feat.shape
        assert bbox_feat.shape == (4, C.OBSERVATION_FRAMES_NUM, 4), bbox_feat.shape
        assert valid_mask.shape == (5, C.OBSERVATION_FRAMES_NUM), valid_mask.shape
        return {
            "name": full_names,
            "feat": feat.astype(np.float32),
            "bbox_feat": bbox_feat.astype(np.float32),
            "valid_mask": valid_mask.astype(np.float32),
            "times": times,
            "start_time": action.start_time,
            "frames_idxs": idxs,
            "image_abs_paths": abs_paths,
        }

    # -- items ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.actions)

    def sample_different_action(self, action: EpicAction) -> EpicAction:
        while True:
            cand = self.rng.choice(self.actions)
            if not cand.narration:
                continue
            if (
                cand.verb != action.verb
                and cand.verb_class != action.verb_class
                and cand.noun != action.noun
                and cand.noun_class != action.noun_class
            ):
                return cand

    def _narration(self, action: EpicAction) -> Tuple[str, EpicAction]:
        if self.use_wrong_narration:
            action = self.sample_different_action(action)
        narration = action.narration or ""
        if self.rng.random() < self.rephrase_rate:
            narration = C.rephrase_narration(narration, self.rng)
        if isinstance(narration, list):
            narration = narration[0]
        return narration, action

    def _image(self, d: Dict) -> np.ndarray:
        if self.load_images:
            img = load_video_frames(d["image_abs_paths"], C.IMAGE_ASPECT_RATIO)
        else:
            img = np.zeros((C.OBSERVATION_FRAMES_NUM, 3, 224, 224), np.float32)
        assert img.shape == (C.OBSERVATION_FRAMES_NUM, 3, 224, 224), img.shape
        return img

    def __getitem__(self, idx: int) -> Tuple[Dict, EpicAction]:
        action = self.actions[idx]
        d = self.load_hoi_features(action)
        d["image"] = self._image(d)
        d["uid"] = action.uid
        d.update(self.labels[action.uid])
        if "test" not in self.split:
            d["verb_class"] = action.verb_class
            d["noun_class"] = action.noun_class
            d["action_class"] = action.action_class
            d["label"] = np.asarray(
                [action.verb_class, action.noun_class, action.action_class], np.int64
            )
        d["narration"], action = self._narration(action)
        return d, action


class EpicHOIDatasetEval(EpicHOIDataset):
    """Eval dataset over amazon-annotated labels (epic_structures.py:432-489)."""

    def __init__(self, df, split, ek_version, load_images=True, rephrase_rate=0.0,
                 use_wrong_narration=False, lmdb_env=None, eval_labels=None, rng=None,
                 np_rng=None):
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = np_rng if np_rng is not None else np.random.default_rng(0)
        self.split = split
        self.ek_version = ek_version
        self.load_images = load_images
        self.rephrase_rate = rephrase_rate
        self.use_wrong_narration = use_wrong_narration
        self.actions, self.actions_invalid = actions_from_df(df, split)
        if eval_labels is None:
            with open(C.eval_label_path(ek_version), "rb") as f:
                eval_labels = pickle.load(f)
        self.eval_labels = eval_labels
        self.labels = {}
        self.env = lmdb_env if lmdb_env is not None else _open_lmdb(C.lmdb_path(ek_version))

    def load_eval_labels(self, uid):
        return process_eval_video_info(self.eval_labels[uid])

    def __getitem__(self, idx):
        action = self.actions[idx]
        d = self.load_hoi_features(action)
        d["image"] = self._image(d)
        d["uid"] = action.uid
        d["verb_class"] = action.verb_class
        d["noun_class"] = action.noun_class
        d["action_class"] = action.action_class
        d["label"] = np.asarray(
            [action.verb_class, action.noun_class, action.action_class], np.int64
        )
        gt_hands, gt_hand_valid = self.load_eval_labels(action.uid)
        d["gt_hands"] = gt_hands
        d["gt_hand_valid"] = gt_hand_valid
        d["gt_label_valid"] = True
        d["narration"], _ = self._narration(action)
        return d, action


def get_epic_hoi_dataset_by_name(
    ek_version: str,
    split: str,
    load_images: bool = True,
    rephrase_rate: float = 0.0,
    use_wrong_narration: bool = False,
    use_percentage: float = 1.0,
    rng: Optional[random.Random] = None,
    np_rng: Optional[np.random.Generator] = None,
):
    """Factory mirroring hoi_forecast/dataset/dataset.py:5-19."""
    from handsonvlm_torch.data.annotation import get_annotation

    df = get_annotation(ek_version, split)
    if split != "eval":
        return EpicHOIDataset(
            df, split, ek_version, load_images=load_images,
            rephrase_rate=rephrase_rate, use_wrong_narration=use_wrong_narration,
            use_percentage=use_percentage, rng=rng, np_rng=np_rng,
        )
    return EpicHOIDatasetEval(
        df, "eval", ek_version, load_images=load_images,
        rephrase_rate=rephrase_rate, use_wrong_narration=use_wrong_narration, rng=rng,
        np_rng=np_rng,
    )
