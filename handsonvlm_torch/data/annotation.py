"""EPIC-KITCHENS annotation loading (host-side, without pandas).

Port of `handsonvlm_tpu/data/annotation.py` (behavioral spec from
`hoi_forecast/dataset/annotation.py:14-245`): EK55/EK100 csv parsing,
RULSTM train/val splits, actions.csv generation, uid layout (EK100 uids =
row index, validation offset by len(train)), label filtering via
video_info.json.

The JAX package reads the CSVs with pandas; the port reads them with the
stdlib `csv` module into `Table`, which keeps the few DataFrame operations
the loaders use and types each column as pandas' `read_csv` infers it: a
column whose cells all read as integers holds Python ints, one whose cells
read as numbers (or are empty) holds floats with NaN for the empty cells,
one of True / False cells holds bools, any other column holds strings; an
empty cell outside a number column is NaN.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pickle
import re
import types
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from handsonvlm_torch.data import epic_constants as C

# pandas.read_csv's default missing-value strings
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Infinity)",
                    re.IGNORECASE)


def _typed_column(cells: Sequence[str]) -> list:
    """One CSV column's cells -> values typed as pandas infers them."""
    present = [c for c in cells if c not in NA_VALUES]
    if len(present) == len(cells) and present and all(_INT.fullmatch(c) for c in present):
        return [int(c) for c in cells]
    if all(_FLOAT.fullmatch(c) for c in present):
        return [float(c) if c not in NA_VALUES else math.nan for c in cells]
    if present and all(c in ("True", "False") for c in present):
        return [c == "True" if c not in NA_VALUES else math.nan for c in cells]
    return [c if c not in NA_VALUES else math.nan for c in cells]


def _py(value):
    """numpy scalars -> Python numbers (a column holds Python values)."""
    return value.item() if isinstance(value, np.generic) else value


class Column(list):
    """A table column: its values in row order."""

    def map(self, fn: Callable) -> "Column":
        return Column(fn(v) for v in self)

    def isin(self, values: Iterable) -> List[bool]:
        values = set(values)
        return [v in values for v in self]


class Table:
    """Named columns of equal length, rows in file order: the DataFrame
    operations the annotation loaders use (`t["col"]`, `t.col`, assigning
    and deleting a column, `len`, `"col" in t`, `filter` for `df.loc[mask]`,
    `itertuples` and `iterrows` for rows with attribute access, `to_csv`)."""

    def __init__(self, columns: Dict[str, Sequence]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length {sorted(lengths)}")
        self._cols = {k: Column(_py(x) for x in v) for k, v in columns.items()}
        self._n = lengths.pop() if lengths else 0

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> Column:
        return self._cols[name]

    def __getattr__(self, name: str) -> Column:
        cols = self.__dict__.get("_cols", {})
        if name in cols:
            return cols[name]
        raise AttributeError(name)

    def __setitem__(self, name: str, values) -> None:
        values = Column(_py(x) for x in values)
        if self._cols and len(values) != self._n:
            raise ValueError(f"column {name!r} has {len(values)} values for {self._n} rows")
        self._n = len(values)
        self._cols[name] = values

    def __delitem__(self, name: str) -> None:
        del self._cols[name]

    def filter(self, mask: Sequence[bool]) -> "Table":
        """The rows where `mask` holds (pandas' `df.loc[mask]`)."""
        keep = [i for i, m in enumerate(mask) if m]
        return Table({k: [v[i] for i in keep] for k, v in self._cols.items()})

    def row(self, i: int) -> types.SimpleNamespace:
        return types.SimpleNamespace(**{k: v[i] for k, v in self._cols.items()})

    def itertuples(self) -> Iterator[types.SimpleNamespace]:
        return (self.row(i) for i in range(self._n))

    def iterrows(self) -> Iterator[Tuple[int, types.SimpleNamespace]]:
        return ((i, self.row(i)) for i in range(self._n))

    def to_csv(self, path: str) -> None:
        """Write with a header and no index, NaN as an empty cell."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.columns)
            for i in range(self._n):
                w.writerow(["" if isinstance(v, float) and math.isnan(v) else v
                            for v in (c[i] for c in self._cols.values())])


def read_csv(path: str, names: Optional[Sequence[str]] = None) -> Table:
    """A CSV file -> Table. Without `names` the first line is the header;
    with `names` every line is data (pandas' `read_csv(path, names=...)`)."""
    with open(path, newline="") as f:
        lines = [r for r in csv.reader(f) if r]
    header = list(names) if names is not None else lines[0]
    body = lines if names is not None else lines[1:]
    width = len(header)
    body = [r + [""] * (width - len(r)) if len(r) < width else r[:width] for r in body]
    return Table({h: _typed_column([r[j] for r in body]) for j, h in enumerate(header)})


def timestr2sec(t_str: str) -> float:
    hh, mm, ss = [float(x) for x in t_str.split(":")]
    return hh * 3600.0 + mm * 60.0 + ss


def str2list(s: str, out_type=None):
    s = s.replace("[", "").replace("]", "").replace("'", "")
    parts = s.split(", ")
    if out_type is not None:
        parts = [out_type(p) for p in parts]
    return parts


def read_rulstm_splits(rulstm_dir: str) -> Tuple[Table, Table]:
    header = ["uid", "video_id", "start_frame", "stop_frame", "verb_class", "noun_class", "action_class"]
    df_train = read_csv(os.path.join(rulstm_dir, "training.csv"), names=header)
    df_validation = read_csv(os.path.join(rulstm_dir, "validation.csv"), names=header)
    return df_train, df_validation


def create_actions_df(ek_version: str, out_path: str) -> None:
    """RULSTM actions.csv -> normalized action table (annotation.py:65-122,
    rulstm-splits branch — the shipped configuration)."""
    df_actions = read_csv(os.path.join(C.rulstm_annotation_dir(ek_version), "actions.csv"))
    if ek_version == "ek100":
        df_actions["action"] = df_actions.action.map(lambda x: x.replace(" ", "_"))
    df_actions["verb_class"] = df_actions.verb
    df_actions["noun_class"] = df_actions.noun
    df_actions["verb"] = df_actions.action.map(lambda x: x.split("_")[0])
    df_actions["noun"] = df_actions.action.map(lambda x: x.split("_")[1])
    df_actions["action_class"] = df_actions.id
    del df_actions["id"]
    df_actions.to_csv(out_path)


def _attach_action_classes(df: Table, ek_version: str) -> Table:
    actions_df_path = os.path.join(C.annotation_dir(ek_version), "actions.csv")
    if not os.path.exists(actions_df_path):
        # fall back to a writable location if the annotation dir is read-only
        alt = os.path.join(C.label_cache_dir(ek_version), "actions.csv")
        if not os.path.exists(alt):
            os.makedirs(os.path.dirname(alt), exist_ok=True)
            create_actions_df(ek_version, alt)
        actions_df_path = alt
    df_actions = read_csv(actions_df_path)

    action_classes, actions = [], []
    lut = {
        (int(r.verb_class), int(r.noun_class)): (int(r.action_class), r.action)
        for r in df_actions.itertuples()
    }
    for _, row in df.iterrows():
        a_cl, a = lut[(int(row.verb_class), int(row.noun_class))]
        action_classes.append(a_cl)
        actions.append(a)
    df["action_class"] = action_classes
    df["action"] = actions
    df["all_nouns"] = df["all_nouns"].map(lambda x: str2list(x) if isinstance(x, str) else x)
    df["all_noun_classes"] = df["all_noun_classes"].map(
        lambda x: str2list(x, int) if isinstance(x, str) else x
    )
    return df


def get_ek100_annotation(split: str, use_label_only: bool = True) -> Table:
    adir = C.annotation_dir("ek100")
    if split == "train":
        df = read_csv(os.path.join(adir, "EPIC_100_train.csv"))
        uids = list(range(len(df)))
    elif split == "validation":
        df_train = read_csv(os.path.join(adir, "EPIC_100_train.csv"))
        df = read_csv(os.path.join(adir, "EPIC_100_validation.csv"))
        uids = [i + len(df_train) for i in range(len(df))]
    elif split == "evaluation" or split == "eval":
        df_train = read_csv(os.path.join(adir, "EPIC_100_train.csv"))
        df = read_csv(os.path.join(adir, "EPIC_100_validation.csv"))
        df["uid"] = [i + len(df_train) for i in range(len(df))]
        with open(C.eval_label_path("ek100"), "rb") as f:
            eval_uids = set(pickle.load(f).keys())
        df = df.filter(df["uid"].isin(eval_uids))
        uids = None
    elif split == "test":
        df_train = read_csv(os.path.join(adir, "EPIC_100_train.csv"))
        df_val = read_csv(os.path.join(adir, "EPIC_100_validation.csv"))
        df = read_csv(os.path.join(adir, "EPIC_100_test_timestamps.csv"))
        uids = [i + len(df_train) + len(df_val) for i in range(len(df))]
    else:
        raise ValueError(f"split {split} not supported")

    df["start_time"] = df["start_timestamp"].map(timestr2sec)
    df["stop_time"] = df["stop_timestamp"].map(timestr2sec)
    if "uid" not in df and uids is not None:
        df["uid"] = uids

    if use_label_only and split in ("train", "validation"):
        with open(C.video_info_path("ek100")) as f:
            uids_label = json.load(f)
        df = df.filter(df["uid"].isin(uids_label))

    if "test" not in split:
        df = _attach_action_classes(df, "ek100")
    return df


def get_ek55_annotation(split: str, use_label_only: bool = True) -> Table:
    adir = C.annotation_dir("ek55")
    if split in ("train", "validation"):
        df = read_csv(os.path.join(adir, "EPIC_train_action_labels.csv"))
        if use_label_only:
            with open(C.video_info_path("ek55")) as f:
                uids_label = json.load(f)
            df = df.filter(df["uid"].isin(uids_label))
        df_train_r, df_val_r = read_rulstm_splits(C.rulstm_annotation_dir("ek55"))
        keep = df_train_r if split == "train" else df_val_r
        df = df.filter(df["uid"].isin(keep["uid"]))
    elif split in ("eval", "evaluation"):
        df = read_csv(os.path.join(adir, "EPIC_train_action_labels.csv"))
        with open(C.eval_label_path("ek55"), "rb") as f:
            eval_uids = set(pickle.load(f).keys())
        df = df.filter(df["uid"].isin(eval_uids))
    elif split in ("test_s1", "test_s2"):
        df = read_csv(os.path.join(adir, f"EPIC_{split}_timestamps.csv"))
    else:
        raise ValueError(f"split {split} not supported")

    df["start_time"] = df["start_timestamp"].map(timestr2sec)
    df["stop_time"] = df["stop_timestamp"].map(timestr2sec)
    if "test" not in split:
        df = _attach_action_classes(df, "ek55")
    return df


def get_annotation(ek_version: str, split: str, use_label_only: bool = True) -> Table:
    if ek_version == "ek100":
        return get_ek100_annotation(split, use_label_only)
    if ek_version == "ek55":
        return get_ek55_annotation(split, use_label_only)
    raise ValueError(ek_version)
