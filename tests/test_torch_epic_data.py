"""The port's EPIC data path (handsonvlm_torch/data/: epic_constants,
epic_utils, action_sampler, annotation, epic_structures, epic_dataset,
native_lmdb, native_loader) on the CPU, held against the JAX package's
modules on the same files and seeds.

- Ports of tests/test_epic_data.py, test_native_lmdb.py and
  test_native_loader.py, run against the port.
- Annotation rows: the port reads the CSVs without pandas (data/annotation.py
  `Table`); every split of EK100 (train, validation, eval, evaluation, test)
  and EK55 (train, validation, eval, test_s1), the RULSTM splits without a
  header and a test-timestamps CSV without labels equal the JAX package's
  DataFrames field by field, types as pandas infers them.
- Items: EpicHOIDataset and the conversation datasets give the same feat,
  bbox_feat, valid_mask, future_hands, future_valid, image, label,
  narration, prompt and token ids as the JAX ones (exact; 1e-6 for float
  arrays built the same way), the JAX side's global `random` seeded as the
  port's `random.Random`.
- LMDB bytes written by either writer are identical and read by either
  reader; the native frame loader decodes as the JAX one does.
"""

import math
import os
import pickle
import random
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from handsonvlm_tpu.data import annotation as j_annotation
from handsonvlm_tpu.data import epic_constants as JC
from handsonvlm_tpu.data import epic_dataset as j_epic_dataset
from handsonvlm_tpu.data import epic_structures as j_structures
from handsonvlm_tpu.data import epic_utils as j_epic_utils
from handsonvlm_tpu.data import native_lmdb as j_lmdb
from handsonvlm_tpu.data import native_loader as j_loader
from handsonvlm_tpu.data.action_sampler import sample_history_frames as j_sample_history_frames
from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JMockTokenizer

import chip_smoke
from handsonvlm_torch.constants import HAND_TOKEN_ID, IMAGE_TOKEN_INDEX
from handsonvlm_torch.data import annotation
from handsonvlm_torch.data import epic_constants as C
from handsonvlm_torch.data import native_loader
from handsonvlm_torch.data.action_sampler import sample_history_frames
from handsonvlm_torch.data.epic_dataset import (
    EpicConversationDataset,
    EpicMultiturnConversationDataset,
    EpicReasoningConversationDataset,
    tile_frames_to_100,
)
from handsonvlm_torch.data.epic_structures import (
    EpicHOIDataset,
    _open_lmdb,
    actions_from_df,
    get_epic_hoi_dataset_by_name,
)
from handsonvlm_torch.data.epic_utils import (
    process_eval_video_info,
    process_video_info,
    sample_hand_trajectory,
)
from handsonvlm_torch.data.hybrid_dataset import Collator, HybridDataset
from handsonvlm_torch.data.mock_tokenizer import MockTokenizer
from handsonvlm_torch.data.native_lmdb import (
    NativeLmdbDict,
    native_available,
    write_lmdb_fixture,
    write_lmdb_pickled,
)
from handsonvlm_torch.data.video_io import load_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# ports of tests/test_epic_data.py
# ---------------------------------------------------------------------------


def _fake_df(n=6):
    rows = []
    for i in range(n):
        start = 200.0 + 10 * i  # seconds
        rows.append(dict(
            uid=1000 + i, participant_id="P01", video_id="P01_01", verb="open",
            verb_class=2, noun="fridge", noun_class=5, all_nouns=["fridge"],
            all_noun_classes=[5], start_frame=int(start * 60) + 1,
            stop_frame=int((start + 2) * 60), start_time=start, stop_time=start + 2.0,
            action="open_fridge", action_class=7, narration="open the fridge"))
    # one invalid action (starts before the anticipation window)
    rows.append(dict(rows[0], uid=999, start_time=0.5, start_frame=31))
    return annotation.Table({k: [r[k] for r in rows] for k in rows[0]})


class FakeLmdb(dict):
    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        rng = np.random.default_rng(sum(key) % 2**31)
        g = rng.normal(size=(1024,)).astype(np.float32)
        return {
            "GLOBAL_FEAT": g,
            "HAND_RIGHT_FEAT": g * 0.5,
            "HAND_RIGHT_BBOX": np.asarray([0.1, 0.1, 0.3, 0.3]),
            # left hand absent -> defaults kick in
            "OBJECT_RIGHT_FEAT": g * 0.2,
            "OBJECT_RIGHT_BBOX": np.asarray([0.2, 0.2, 0.4, 0.4]),
        }


def _video_info():
    traj = np.cumsum(np.ones((21, 2), np.float32) * 5, axis=0) + 100
    return {"frame_indices": [123], "hand_trajs": {"RIGHT": {"traj": traj}},
            "affordance": {"select_points_homo": np.asarray([[228.0, 128.0]])}}


def _labels(uids, process=process_video_info):
    out = {}
    for uid in uids:
        fh, cp, fv, _ = process(_video_info(), np.random.default_rng(0))
        out[int(uid)] = {"future_hands": fh, "contact_point": cp, "future_valid": fv}
    return out


@pytest.fixture
def hoi_dataset():
    df = _fake_df()
    return EpicHOIDataset(df, "train", "ek100", load_images=False, lmdb_env=FakeLmdb(),
                          labels=_labels(df.uid), rng=random.Random(0))


def test_action_sampler_window():
    times, idxs = sample_history_frames(60 * 60 + 1)  # action at t=60s
    assert len(idxs) == 10
    # last observed frame is 1s before the action start
    assert abs(times[-1] - 59.0) < 1 / 60
    # 4 fps spacing = 15 source frames
    assert np.all(np.diff(idxs) == 15)


def test_sample_hand_trajectory_normalization():
    traj = np.stack([np.linspace(0, 456, 21), np.linspace(0, 256, 21)], axis=1)
    pts, indices = sample_hand_trajectory(traj.astype(np.float32))
    assert pts.shape == (5, 2)
    assert indices == [0, 5, 10, 15, 20]
    np.testing.assert_allclose(pts[-1], [1.0, 1.0])


def test_validity_filter():
    actions, invalid = actions_from_df(_fake_df(), "train")
    assert len(invalid) == 1 and invalid[0].uid == 999


def test_hoi_dataset_shapes(hoi_dataset):
    d, action = hoi_dataset[0]
    assert d["feat"].shape == (5, 10, 1024)
    assert d["bbox_feat"].shape == (4, 10, 4)
    assert d["valid_mask"].shape == (5, 10)
    assert d["future_hands"].shape == (2, 5, 2)
    assert d["future_valid"].tolist() == [1, 0]  # left hand absent
    # absent left hand gets the (0.25, 1.5) default trajectory
    np.testing.assert_allclose(d["future_hands"][1, 0], [0.25, 1.5])
    assert d["narration"] == "open the fridge"
    # left-hand valid_mask rows are zero (bbox absent)
    assert d["valid_mask"][2].sum() == 0


def test_conversation_dataset_and_collator(hoi_dataset):
    tok = MockTokenizer()
    ds = EpicConversationDataset(tok, hoi_dataset, deterministic=True)
    item = ds[0]
    ids = np.asarray(item["input_ids"])
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    assert (ids == HAND_TOKEN_ID).sum() == 4
    labels = np.asarray(item["labels"])
    assert (labels == HAND_TOKEN_ID).sum() == 4
    assert item["image"].shape == (100, 3, 224, 224)

    batch = Collator(pad_token_id=tok.pad_token_id)([ds[0], ds[1]])
    assert batch["input_ids"].shape == batch["labels"].shape
    assert batch["input_ids"].shape[1] % 64 == 0
    assert batch["image"].shape == (2, 100, 3, 224, 224)
    assert batch["future_hands"].shape == (2, 2, 5, 2)
    assert batch["attn_mask"].dtype == bool


def test_multiturn_modes(hoi_dataset):
    tok = MockTokenizer()
    ds = EpicMultiturnConversationDataset(tok, hoi_dataset)
    for _ in range(8):
        item = ds[0]
        n_hand = (np.asarray(item["input_ids"]) == HAND_TOKEN_ID).sum()
        assert n_hand in (0, 4)  # some modes have no trajectory turn


def test_hybrid_mixture(hoi_dataset):
    tok = MockTokenizer()
    ds1 = EpicConversationDataset(tok, hoi_dataset)
    hybrid = HybridDataset(task_datasets=[[ds1]], task_sample_rate=[1.0], samples_per_epoch=17)
    assert len(hybrid) == 17
    item = hybrid[0]
    assert "input_ids" in item


def test_tile_frames():
    x = np.arange(10)[:, None, None, None] * np.ones((10, 3, 2, 2))
    out = tile_frames_to_100(x)
    assert out.shape == (100, 3, 2, 2)
    np.testing.assert_allclose(out[:10, 0, 0, 0], np.arange(10))
    np.testing.assert_allclose(out[10:20, 0, 0, 0], np.arange(10))


# ---------------------------------------------------------------------------
# side by side: the small functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [1, 31, 601, 60 * 60 + 1, 123457])
def test_sample_history_frames_match_jax(start):
    t, i = sample_history_frames(start)
    jt, ji = j_sample_history_frames(start)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(i, ji)
    assert i.dtype == ji.dtype and t.dtype == jt.dtype


def test_process_video_info_matches_jax():
    rng = np.random.default_rng(3)
    info = {"hand_trajs": {"LEFT": {"traj": rng.uniform(0, 400, (21, 2)).astype(np.float32)}},
            "affordance": {"select_points_homo": rng.uniform(0, 400, (7, 2))},
            "frame_indices": [17]}
    got = process_video_info(info, np.random.default_rng(5))
    want = j_epic_utils.process_video_info(info, np.random.default_rng(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    eval_info = {"RIGHT": rng.uniform(-0.2, 1.2, (5, 2)).astype(np.float32)}
    for g, w in zip(process_eval_video_info(eval_info),
                    j_epic_utils.process_eval_video_info(eval_info)):
        np.testing.assert_array_equal(g, w)


def test_rephrase_narration_draws_from_the_given_rng(tmp_path, monkeypatch):
    import json

    (tmp_path / "rephrase_ek100.json").write_text(json.dumps(
        {"open the fridge": ["open it", "pull the fridge door", "get into the fridge"],
         "alias": "open the fridge", "close the tap": "alias"}))
    monkeypatch.setenv("HANDSONVLM_ASSETS_DIR", str(tmp_path))
    JC._rephrase_dict.cache_clear()
    try:
        for seed in range(4):
            random.seed(seed)
            want = [JC.rephrase_narration(n) for n in ("open the fridge", "close the tap", "x")]
            rng = random.Random(seed)
            got = [C.rephrase_narration(n, rng) for n in ("open the fridge", "close the tap", "x")]
            assert got == want
    finally:
        JC._rephrase_dict.cache_clear()


# ---------------------------------------------------------------------------
# annotations: the port's Table against the JAX package's DataFrames
# ---------------------------------------------------------------------------

EK100_COLS = ["narration_id", "participant_id", "video_id", "narration_timestamp",
              "start_timestamp", "stop_timestamp", "start_frame", "stop_frame", "narration",
              "verb", "verb_class", "noun", "noun_class", "all_nouns", "all_noun_classes"]
VERBS = [("open", 0), ("take", 1), ("wash", 2), ("cut", 3)]
NOUNS = [("fridge", 0), ("knife", 1), ("cup", 2), ("onion", 3), ("tap", 4)]


def _ts(sec):
    return f"{int(sec // 3600):02d}:{int(sec // 60) % 60:02d}:{sec % 60:06.3f}"


def _ek_rows(rng, n, first_sec, with_uid=False, uid0=0):
    rows = []
    for i in range(n):
        (verb, vc), (noun, nc) = VERBS[i % 4], NOUNS[(i * 3) % 5]
        start = first_sec + 7.5 * i + float(rng.integers(0, 100)) / 10
        nouns = [noun] + ([NOUNS[(i + 1) % 5][0]] if i % 3 == 0 else [])
        classes = [nc] + ([NOUNS[(i + 1) % 5][1]] if i % 3 == 0 else [])
        row = {"narration_id": f"P01_01_{i}", "participant_id": "P01", "video_id": "P01_01",
               "narration_timestamp": _ts(start - 0.2), "start_timestamp": _ts(start),
               "stop_timestamp": _ts(start + 3.1), "start_frame": int(start * 60) + 1,
               "stop_frame": int((start + 3.1) * 60),
               "narration": f"{verb} the {noun}" if i != 2 else "",
               "verb": verb, "verb_class": vc, "noun": noun, "noun_class": nc,
               "all_nouns": str(nouns) if i != 4 else "",
               "all_noun_classes": str(classes) if i != 4 else ""}
        if with_uid:
            row = {"uid": uid0 + i, **row}
        rows.append(row)
    return rows


def _write_annotations(root):
    """EK100 and EK55 annotation layouts, written with pandas as the
    reference's files are: empty cells (a narration, a noun list), quoted
    lists, RULSTM splits without a header, test timestamps without labels,
    EK55's actions.csv made from the RULSTM table."""
    rng = np.random.default_rng(0)
    ek100 = root / "common" / "epic-kitchens-100-annotations"
    ek55 = root / "common" / "epic-kitchens-55-annotations"
    rulstm55 = root / "common" / "rulstm" / "RULSTM" / "data" / "ek55"
    for d in (ek100, ek55, rulstm55, root / "ek100", root / "ek55"):
        d.mkdir(parents=True, exist_ok=True)
    train, val = _ek_rows(rng, 9, 20.0), _ek_rows(rng, 6, 400.0)
    pd.DataFrame(train, columns=EK100_COLS).to_csv(ek100 / "EPIC_100_train.csv", index=False)
    pd.DataFrame(val, columns=EK100_COLS).to_csv(ek100 / "EPIC_100_validation.csv",
                                                 index=False)
    test = [{k: r[k] for k in ("narration_id", "participant_id", "video_id",
                                "start_timestamp", "stop_timestamp", "start_frame",
                                "stop_frame")} for r in _ek_rows(rng, 4, 900.0)]
    pd.DataFrame(test).to_csv(ek100 / "EPIC_100_test_timestamps.csv", index=False)
    pd.DataFrame([{"verb": v, "noun": n, "verb_class": vc, "noun_class": nc,
                   "action": f"{v}_{n}", "action_class": 5 * vc + nc}
                  for v, vc in VERBS for n, nc in NOUNS]).to_csv(ek100 / "actions.csv",
                                                                 index=False)
    (root / "ek100" / "video_info.json").write_text(str([0, 2, 3, 5, 7, 8, 9, 10, 12, 14]))
    with open(root / "ek100" / "ek100_eval_labels.pkl", "wb") as f:
        pickle.dump({10: {}, 11: {}, 13: {}, 99: {}}, f)

    rows55 = _ek_rows(rng, 12, 50.0, with_uid=True, uid0=100)
    cols55 = ["uid", "participant_id", "video_id", "narration", "start_timestamp",
              "stop_timestamp", "start_frame", "stop_frame", "verb", "verb_class", "noun",
              "noun_class", "all_nouns", "all_noun_classes"]
    pd.DataFrame(rows55, columns=cols55).to_csv(ek55 / "EPIC_train_action_labels.csv",
                                                index=False)
    for name, part in (("training.csv", rows55[:8]), ("validation.csv", rows55[8:])):
        pd.DataFrame([[r["uid"], r["video_id"], r["start_frame"], r["stop_frame"],
                       r["verb_class"], r["noun_class"], 5 * r["verb_class"] + r["noun_class"]]
                      for r in part]).to_csv(rulstm55 / name, index=False, header=False)
    pd.DataFrame([{"id": 5 * vc + nc, "verb": vc, "noun": nc, "action": f"{v}_{n}"}
                  for v, vc in VERBS for n, nc in NOUNS]).to_csv(rulstm55 / "actions.csv",
                                                                 index=False)
    test55 = [{k: r[k] for k in ("uid", "participant_id", "video_id", "start_timestamp",
                                 "stop_timestamp", "start_frame", "stop_frame")}
              for r in _ek_rows(rng, 3, 700.0, with_uid=True, uid0=500)]
    pd.DataFrame(test55).to_csv(ek55 / "EPIC_test_s1_timestamps.csv", index=False)
    (root / "ek55" / "video_info.json").write_text(str(list(range(100, 112, 2))))
    with open(root / "ek55" / "ek55_eval_labels.pkl", "wb") as f:
        pickle.dump({101: {}, 104: {}, 109: {}}, f)


@pytest.fixture(scope="module")
def annotation_roots(tmp_path_factory):
    """Two copies of one annotation tree: the JAX loaders write EK55's
    actions.csv into theirs, the port's into its own."""
    base = tmp_path_factory.mktemp("ann")
    _write_annotations(base / "jax")
    shutil.copytree(base / "jax", base / "port")
    return base / "jax", base / "port"


def _same_cell(got, want):
    """A port cell against a pandas cell: the same value, typed as pandas
    typed it (int64 -> int, float64 -> float with NaN, object -> str or
    list, NaN for an empty object cell)."""
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if isinstance(want, np.integer):
        return type(got) is int and got == int(want)
    if isinstance(want, np.floating):
        return type(got) is float and got == float(want)
    if isinstance(want, np.bool_):
        return type(got) is bool and got == bool(want)
    return type(got) is type(want) and got == want


def _assert_table_equals_frame(table, df):
    assert table.columns == list(df.columns)
    assert len(table) == len(df)
    for name in df.columns:
        col = df[name]
        for i, (got, want) in enumerate(zip(table[name], col.tolist() if col.dtype == object
                                            else col.to_numpy())):
            assert _same_cell(got, want), (name, i, got, want)


SPLITS = [("ek100", "train"), ("ek100", "validation"), ("ek100", "eval"),
          ("ek100", "evaluation"), ("ek100", "test"), ("ek55", "train"),
          ("ek55", "validation"), ("ek55", "eval"), ("ek55", "test_s1")]


@pytest.mark.parametrize("ek_version, split", SPLITS, ids=[f"{v}-{s}" for v, s in SPLITS])
def test_annotation_rows_equal_the_jax_frames(annotation_roots, monkeypatch, ek_version, split):
    jax_root, port_root = annotation_roots
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(jax_root))
    want = j_annotation.get_annotation(ek_version, split)
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(port_root))
    got = annotation.get_annotation(ek_version, split)
    assert len(got) > 0
    _assert_table_equals_frame(got, want)
    # and as actions: the EpicAction fields the datasets read
    ga, gi = actions_from_df(got, split)
    wa, wi = j_structures.actions_from_df(want, split)
    assert len(ga) == len(wa) and len(gi) == len(wi)
    for g, w in zip(ga + gi, wa + wi):
        for field, value in vars(w).items():
            assert _same_cell(getattr(g, field), value), (field, getattr(g, field), value)


def test_rulstm_splits_without_a_header(annotation_roots):
    jax_root, port_root = annotation_roots
    rdir = "common/rulstm/RULSTM/data/ek55"
    got = annotation.read_rulstm_splits(str(port_root / rdir))
    want = j_annotation.read_rulstm_splits(str(jax_root / rdir))
    for g, w in zip(got, want):
        _assert_table_equals_frame(g, w)
    assert len(got[0]) == 8 and len(got[1]) == 4  # no header line taken as data or dropped


def test_created_actions_table_equals_jax(annotation_roots, tmp_path, monkeypatch):
    """EK55 has no actions.csv in its annotation dir: both build it from
    the RULSTM table; the two files read back the same."""
    jax_root, port_root = annotation_roots
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(jax_root))
    j_annotation.create_actions_df("ek55", str(tmp_path / "jax.csv"))
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(port_root))
    annotation.create_actions_df("ek55", str(tmp_path / "port.csv"))
    _assert_table_equals_frame(annotation.read_csv(str(tmp_path / "port.csv")),
                               pd.read_csv(tmp_path / "jax.csv"))
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port.csv"),
                                  pd.read_csv(tmp_path / "jax.csv"))


def test_read_csv_types_cells_as_pandas(tmp_path):
    """The column typing rule on the cells the reference's files hold:
    ints, ints with a gap (floats with NaN), floats, bools, quoted commas,
    missing-value strings, an all-empty column, short rows."""
    path = tmp_path / "mixed.csv"
    path.write_text(
        "a,b,c,d,e,f,g,h\n"
        "1,2,0.5,True,\"x, y\",NA,,-3\n"
        "2,,1e3,False,plain,n/a,,+4\n"
        "3,5,-.25,True,\"['p', 'q']\",z,,5\n"
        "4,6,inf,False,None,w,,6\n"
        "5,7,8\n")
    want = pd.read_csv(path)
    got = annotation.read_csv(str(path))
    _assert_table_equals_frame(got, want)
    names = ["p", "q", "r"]
    path2 = tmp_path / "nohead.csv"
    path2.write_text("1,a,2.5\n2,b,3.5\n")
    _assert_table_equals_frame(annotation.read_csv(str(path2), names=names),
                               pd.read_csv(path2, names=names))


def test_annotation_loads_without_pandas_or_jax(annotation_roots):
    """The port's annotation path imports neither pandas, jax nor the JAX
    package."""
    _, port_root = annotation_roots
    code = ("import os, sys\n"
            f"os.environ['HANDSONVLM_DATA_ROOT'] = {str(port_root)!r}\n"
            "from handsonvlm_torch.data.annotation import get_annotation\n"
            "import handsonvlm_torch.data.epic_structures, handsonvlm_torch.eval.evaluate\n"
            "for v, s in (('ek100', 'validation'), ('ek100', 'test'), ('ek55', 'train')):\n"
            "    assert len(get_annotation(v, s)) > 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('pandas', 'jax', 'handsonvlm_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# items on an on-disk EK100 layout, against the JAX datasets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ek_roots(tmp_path_factory):
    """chip_smoke's EK100 layout (3 validation clips), one copy a side: each
    side's dataset writes its own label cache."""
    base = tmp_path_factory.mktemp("ek")
    chip_smoke.write_ek_fixture(str(base / "jax"), n_val=3)
    shutil.copytree(base / "jax", base / "port")
    return base / "jax", base / "port"


def _use_root(monkeypatch, root):
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(root))
    monkeypatch.setenv("HANDSONVLM_ASSETS_DIR", str(root / "assets"))


def _assert_item_equal(got, want, roots, skip=()):
    """Key by key; paths compared below their data roots."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if k == "image_abs_paths":
            g = [os.path.relpath(p, roots[1]) for p in g]
            w = [os.path.relpath(p, roots[0]) for p in w]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w or (isinstance(w, float) and math.isnan(w) and math.isnan(g)), k


def test_hoi_items_equal_jax(ek_roots, monkeypatch):
    jax_root, port_root = ek_roots
    _use_root(monkeypatch, jax_root)
    random.seed(0)
    want_ds = j_structures.get_epic_hoi_dataset_by_name("ek100", "validation")
    want = [want_ds[i] for i in range(len(want_ds))]
    _use_root(monkeypatch, port_root)
    got_ds = get_epic_hoi_dataset_by_name("ek100", "validation", rng=random.Random(0))
    got = [got_ds[i] for i in range(len(got_ds))]
    assert len(got) == len(want) == 3
    for (g, ga), (w, wa) in zip(got, want):
        # the contact point is drawn (the JAX package from an unseeded generator)
        _assert_item_equal(g, w, ek_roots, skip=("contact_point",))
        assert g["feat"].shape == (5, 10, 1024) and g["image"].shape == (10, 3, 224, 224)
        assert g["future_hands"].shape == (2, 5, 2) and g["future_valid"].tolist() == [1, 1]
        assert g["label"].tolist() == [ga.verb_class, ga.noun_class, ga.action_class]
        assert vars(ga) == vars(wa)
        assert (0 <= g["contact_point"]).all() and (g["contact_point"] <= 1).all()


def test_hoi_dataset_reads_the_lmdb_natively(ek_roots, monkeypatch):
    """Without lmdbdict / lmdb, _open_lmdb falls back to the port's native
    reader, and the feature dicts equal the JAX package's reader's."""
    _, port_root = ek_roots
    path = str(port_root / "ek100" / "feats" / "full_data_chenbao_processed.lmdb")
    env = _open_lmdb(path)
    assert isinstance(env, NativeLmdbDict)
    jenv = j_lmdb.NativeLmdbDict(path)
    keys = list(env.keys())
    # 4 clips x 10 frames, two frames shared by the train clip and the first
    assert keys == list(jenv.keys()) and len(keys) == 38
    for k in keys:
        g, w = env[k], jenv[k]
        assert sorted(g) == sorted(w)
        for name in w:
            np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("reason", [False, True], ids=["vanilla", "reasoning"])
def test_conversation_items_equal_jax(ek_roots, monkeypatch, seed, reason):
    jax_root, port_root = ek_roots
    jtok, tok = JMockTokenizer(), MockTokenizer()
    rate = 1.0 if reason else 0.0
    _use_root(monkeypatch, jax_root)
    random.seed(seed)
    jhoi = j_structures.get_epic_hoi_dataset_by_name("ek100", "validation", rephrase_rate=rate)
    jcls = (j_epic_dataset.EpicReasoningConversationDataset if reason
            else j_epic_dataset.EpicConversationDataset)
    jds = jcls(jtok, jhoi, deterministic=True)
    want = [jds[i] for i in range(len(jds))]
    _use_root(monkeypatch, port_root)
    hoi = get_epic_hoi_dataset_by_name("ek100", "validation", rephrase_rate=rate,
                                       rng=random.Random(seed))
    cls = EpicReasoningConversationDataset if reason else EpicConversationDataset
    ds = cls(tok, hoi, deterministic=True)
    got = [ds[i] for i in range(len(ds))]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_item_equal(g, w, ek_roots, skip=("contact_point",))  # drawn
        assert (g["image"][10:20] == g["image"][:10]).all()
        assert (np.asarray(g["input_ids"]) == HAND_TOKEN_ID).sum() == 4


def test_multiturn_items_equal_jax(ek_roots, monkeypatch):
    """The training split's multiturn dialogues (mode and templates drawn)
    over the validation clips' labels: the same draws give the same
    conversations and token ids."""
    jax_root, port_root = ek_roots
    _use_root(monkeypatch, jax_root)
    random.seed(3)
    jds = j_epic_dataset.EpicMultiturnConversationDataset(
        JMockTokenizer(), j_structures.get_epic_hoi_dataset_by_name("ek100", "validation",
                                                                    load_images=False))
    want = [jds.get_sources(i % 3)["conversations"] for i in range(12)]
    _use_root(monkeypatch, port_root)
    ds = EpicMultiturnConversationDataset(MockTokenizer(), get_epic_hoi_dataset_by_name(
        "ek100", "validation", load_images=False, rng=random.Random(3)))
    got = [ds.get_sources(i % 3)["conversations"] for i in range(12)]
    assert got == want
    assert len({len(c) for c in got}) == 2  # both the 2- and the 4-turn modes drawn


def test_reasoning_questions_index(ek_roots, monkeypatch):
    """The reasoning dataset keeps the clips whose last observed frame has
    questions, as the JAX one does."""
    jax_root, port_root = ek_roots
    _use_root(monkeypatch, jax_root)
    jds = j_epic_dataset.EpicReasoningConversationDataset(
        JMockTokenizer(), j_structures.get_epic_hoi_dataset_by_name("ek100", "validation",
                                                                    load_images=False))
    _use_root(monkeypatch, port_root)
    ds = EpicReasoningConversationDataset(MockTokenizer(), get_epic_hoi_dataset_by_name(
        "ek100", "validation", load_images=False))
    assert ds.valid_index == jds.valid_index == [0, 1, 2]
    assert ds.reasoning_templates == jds.reasoning_templates


# ---------------------------------------------------------------------------
# ports of tests/test_native_lmdb.py, and the two writers / readers crossed
# ---------------------------------------------------------------------------


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("g++ build of the native lmdb reader unavailable")


def test_small_roundtrip(tmp_path, native):
    data = {b"banana": b"yellow", b"apple": b"red", b"cherry": b"dark"}
    path = write_lmdb_fixture(str(tmp_path / "data.mdb"), data)
    db = NativeLmdbDict(path, unpickle=False)
    assert len(db) == 3
    for k, v in data.items():
        assert k in db
        assert db[k] == v
    assert b"durian" not in db
    with pytest.raises(KeyError):
        db[b"durian"]
    assert db.get(b"nope", 42) == 42
    assert list(db.keys()) == sorted(data)  # B+tree iterates in key order
    db.close()


def test_open_directory(tmp_path, native):
    write_lmdb_pickled(str(tmp_path / "data.mdb"), {b"k": "v"})
    db = NativeLmdbDict(str(tmp_path))  # dir form, like lmdb.open(subdir=True)
    assert db[b"k"] == "v"
    db.close()


def _multilevel_data():
    return {f"P{i:02d}/rgb_frames/P{i:02d}_{j:02d}/frame_{k:010d}.jpg".encode():
            f"value-{i}-{j}-{k}".encode() * 3
            for i in range(6) for j in range(6) for k in range(40)}


def test_multilevel_tree(tmp_path, native):
    # enough keys to force >= 2 branch levels at psize 4096
    data = _multilevel_data()
    assert len(data) > 1000
    path = write_lmdb_fixture(str(tmp_path / "data.mdb"), data)
    db = NativeLmdbDict(path, unpickle=False)
    assert len(db) == len(data)
    keys = sorted(data)
    for k in (keys[0], keys[1], keys[len(keys) // 2], keys[-2], keys[-1]):
        assert db[k] == data[k]
    rng = np.random.default_rng(0)
    for idx in rng.integers(0, len(keys), 200):
        k = keys[int(idx)]
        assert db[k] == data[k]
    assert b"P99/zzz" not in db
    assert b"" not in db  # smaller than every key
    assert list(db.keys()) == keys
    db.close()


def _overflow_data():
    rng = np.random.default_rng(1)
    return {
        b"small": b"x",
        b"one-page": bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
        b"many-pages": bytes(rng.integers(0, 256, 50_000, dtype=np.uint8)),
        b"exact": bytes(4096),
    }


def test_overflow_values(tmp_path, native):
    data = _overflow_data()
    path = write_lmdb_fixture(str(tmp_path / "data.mdb"), data)
    db = NativeLmdbDict(path, unpickle=False)
    for k, v in data.items():
        assert db[k] == v, k
    db.close()


def test_pickled_feature_dicts(tmp_path, native):
    """The reference value format: pickled dict of TSN features + bboxes
    (epic_structures.py GLOBAL/HAND/OBJ feats)."""
    rng = np.random.default_rng(2)
    frame = {
        "GLOBAL_FEAT": rng.standard_normal(1024).astype(np.float32),
        "HAND_RIGHT_FEAT": rng.standard_normal(1024).astype(np.float32),
        "HAND_RIGHT_BBOX": np.asarray([0.1, 0.2, 0.3, 0.4], np.float32),
    }
    key = b"P24/rgb_frames/P24_05/frame_0000075700.jpg"
    path = write_lmdb_pickled(str(tmp_path / "data.mdb"), {key: frame})
    db = NativeLmdbDict(path)
    out = db[key]
    np.testing.assert_array_equal(out["GLOBAL_FEAT"], frame["GLOBAL_FEAT"])
    np.testing.assert_array_equal(out["HAND_RIGHT_BBOX"], frame["HAND_RIGHT_BBOX"])
    db.close()


def test_empty_db(tmp_path, native):
    path = write_lmdb_fixture(str(tmp_path / "data.mdb"), {})
    db = NativeLmdbDict(path, unpickle=False)
    assert len(db) == 0
    assert b"k" not in db
    assert list(db.keys()) == []
    db.close()


def test_epic_structures_integration(tmp_path, native):
    """_open_lmdb falls back to the native reader when lmdb pkgs are absent."""
    key = b"P01/rgb_frames/P01_01/frame_0000000001.jpg"
    write_lmdb_pickled(str(tmp_path / "data.mdb"), {key: {"GLOBAL_FEAT": [1, 2]}})
    env = _open_lmdb(str(tmp_path))
    assert key in env
    assert env[key]["GLOBAL_FEAT"] == [1, 2]


@pytest.mark.parametrize("which", ["small", "multilevel", "overflow", "empty", "pickled"])
def test_lmdb_bytes_equal_jax_and_cross_read(tmp_path, native, which):
    """Both writers give the same file; each reader reads the other's."""
    data = {"small": {b"b": b"2", b"a": b"1"}, "multilevel": _multilevel_data(),
            "overflow": _overflow_data(), "empty": {},
            "pickled": {b"k%d" % i: np.arange(i, dtype=np.float32) for i in range(50)}}[which]
    if which == "pickled":
        port = write_lmdb_pickled(str(tmp_path / "port.mdb"), data)
        jax_path = j_lmdb.write_lmdb_pickled(str(tmp_path / "jax.mdb"), data)
    else:
        port = write_lmdb_fixture(str(tmp_path / "port.mdb"), data)
        jax_path = j_lmdb.write_lmdb_fixture(str(tmp_path / "jax.mdb"), data)
    with open(port, "rb") as f, open(jax_path, "rb") as g:
        assert f.read() == g.read()
    unpickle = which == "pickled"
    a = NativeLmdbDict(jax_path, unpickle=unpickle)
    b = j_lmdb.NativeLmdbDict(port, unpickle=unpickle)
    assert len(a) == len(b) == len(data)
    for (ka, va), (kb, vb) in zip(a.items(), b.items()):
        assert ka == kb
        if unpickle:
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb == data[ka]
    a.close()
    b.close()


def test_native_libraries_build_outside_the_package():
    """The g++ builds land under build/handsonvlm_torch/, never beside the
    sources in the package."""
    assert native_available()
    native_loader.native_available()
    pkg = os.path.join(ROOT, "handsonvlm_torch")
    found = [os.path.join(d, f) for d, _, files in os.walk(pkg) for f in files
             if f.endswith(".so")]
    assert not found, found
    built = os.listdir(os.path.join(ROOT, "build", "handsonvlm_torch"))
    assert any(f.startswith("lmdb_reader_") and f.endswith(".so") for f in built), built


# ---------------------------------------------------------------------------
# ports of tests/test_native_loader.py, and the two loaders crossed
# ---------------------------------------------------------------------------


@pytest.fixture
def jpegs(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(320, 240), (240, 320), (224, 224)]):
        arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(arr).save(p, quality=95)
        paths.append(str(p))
    return paths


@pytest.fixture
def native_jpeg():
    if not native_loader.native_available():
        pytest.skip("no native toolchain (g++ and libjpeg)")


def test_native_matches_pil(jpegs, native_jpeg):
    out, ok = native_loader.load_frames_native(jpegs, size=224, num_threads=2)
    assert ok.all()
    assert out.shape == (3, 3, 224, 224)
    for i, p in enumerate(jpegs):
        ref = load_image(p, cache_dir=None)
        # bicubic implementations differ slightly; compare in normalized
        # space with a loose-but-meaningful tolerance
        diff = np.abs(out[i] - ref)
        assert diff.mean() < 0.03, (i, diff.mean())
        assert np.quantile(diff, 0.99) < 0.25, (i, np.quantile(diff, 0.99))


def test_native_handles_missing_file(tmp_path, jpegs, native_jpeg):
    paths = jpegs + [str(tmp_path / "missing.jpg")]
    out, ok = native_loader.load_frames_native(paths, size=224)
    assert ok[:3].all() and not ok[3]
    np.testing.assert_allclose(out[3], 0.0)


def test_load_frames_fallback(jpegs):
    out = native_loader.load_frames(jpegs, size=224)
    assert out.shape == (3, 3, 224, 224)
    assert np.isfinite(out).all()


def test_native_frames_equal_jax_and_are_counted(jpegs, native_jpeg, monkeypatch):
    """The same C++ source decodes the same bytes: the port's frames equal
    the JAX loader's; `DECODED` says which decoder returned each frame."""
    monkeypatch.setitem(native_loader.DECODED, "native", 0)
    monkeypatch.setitem(native_loader.DECODED, "pil", 0)
    got = native_loader.load_frames(jpegs)
    want = j_loader.load_frames(jpegs)
    np.testing.assert_array_equal(got, want)
    assert native_loader.DECODED == {"native": 3, "pil": 0}
    # a frame the native decoder cannot read (not a JPEG) goes to PIL
    png = str(jpegs[0]).replace(".jpg", ".png")
    Image.open(jpegs[0]).save(png)
    mixed = native_loader.load_frames([png] + jpegs[1:])
    assert native_loader.DECODED == {"native": 5, "pil": 1}
    np.testing.assert_allclose(mixed[0], load_image(png, cache_dir=None), rtol=0, atol=1e-6)


def test_pil_fallback_is_counted(jpegs, monkeypatch):
    """Where the library cannot be built, every frame goes through PIL and
    equals video_io's decode; the counter says so."""
    monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    monkeypatch.setitem(native_loader.DECODED, "native", 0)
    monkeypatch.setitem(native_loader.DECODED, "pil", 0)
    out = native_loader.load_frames(jpegs)
    assert native_loader.DECODED == {"native": 0, "pil": 3}
    for i, p in enumerate(jpegs):
        np.testing.assert_array_equal(out[i], load_image(p, cache_dir=None))
