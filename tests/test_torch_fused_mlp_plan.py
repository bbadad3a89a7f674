"""B11's launch plan (csrc/fused_decode.cu, `fused_mlp_plan`) on the CPU:
for the tiny, 7B and 13B presets and a few edge shapes, at 132 and 114
SMs, each phase's splits fit one cluster and cover its contraction once,
the plan takes no row count, and the C entry point's argument rules
(mirrored in `fused_mlp_refusal`) accept every row count 1..8 at the
presets B11 serves and refuse what `hv_fused_mlp` refuses. The kernels
themselves run on the card (tests/test_torch_kernels.py)."""

import inspect
import math
import re
from pathlib import Path

import pytest
import torch

import handsonvlm_torch
from handsonvlm_torch.config import get_config
from handsonvlm_torch.ops.fused_decode import (
    GROUP,
    ROWS,
    SMEM_CAP,
    UP_SMEM_FIXED,
    XN_GROUP_ROW,
    MlpPlan,
    fused_mlp_ok,
    fused_mlp_plan,
    fused_mlp_refusal,
)
from handsonvlm_torch.ops.int8_matmul import GEMV_COLS, GEMV_MAX_SPLITS, tiled_shapes

N_SM = (132, 114)  # H100 SXM, H100 PCIe


def _tiles(d, f):
    """(BNf, BNd): split_wgu_tiled's gate / up tile width and the int4
    decoder's w_down tile width."""
    bnf = 256 if f % 256 == 0 else math.gcd(f, 256)
    (_, _, _, _, bnd), _ = tiled_shapes(f, d, 1)
    return bnf, bnd


def _preset(name):
    cfg = get_config(name).llama
    return cfg.hidden_size, cfg.intermediate_size


# (d, f) B11 serves: the presets with groups of 128, an f whose gate / up
# tiles are 128 wide and whose down splits end short, a 1B-wide decoder,
# and a d whose xn of 8 rows needs two gate/up splits to fit a block
SHAPES = {"7b": _preset("7b"), "13b": _preset("13b"), "small": (256, 512),
          "tile128_short_split": (256, 1152), "1b": (2048, 5504), "wide_d": (16384, 4096)}


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_mlp_plan_splits_cover_once_in_one_cluster(shape, n_sm):
    d, f = SHAPES[shape]
    bnf, bnd = _tiles(d, f)
    plan = fused_mlp_plan(d, f, bnf, bnd, n_sm)
    # column blocks of 128 within each tile
    assert plan.blocks1 == (f // bnf) * -(-bnf // GEMV_COLS)
    assert plan.blocks2 == (d // bnd) * -(-bnd // GEMV_COLS)
    for units, splits, per in ((d // GROUP, plan.splits1, plan.per1),
                               (f // GROUP, plan.splits2, plan.per2)):
        assert 1 <= splits <= GEMV_MAX_SPLITS
        assert (splits - 1) * per < units <= splits * per
    # a gate/up block's xn of ROWS rows fits its shared memory
    assert UP_SMEM_FIXED + plan.per1 * XN_GROUP_ROW * ROWS <= SMEM_CAP


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("b", range(1, ROWS + 1))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_mlp_plan_is_taken_by_the_entry_point_at_any_row_count(shape, b, n_sm):
    """The plan has no row count, so a row is summed in the same order alone
    or among 8, and the entry point takes it for every B."""
    assert list(inspect.signature(fused_mlp_plan).parameters) == ["d", "f", "bnf", "bnd", "n_sm"]
    d, f = SHAPES[shape]
    bnf, bnd = _tiles(d, f)
    assert fused_mlp_refusal(b, d, f, bnf, bnd, fused_mlp_plan(d, f, bnf, bnd, n_sm)) is None


@pytest.mark.parametrize("preset", ["7b", "13b"])
def test_fused_mlp_plan_at_7b_and_13b(preset):
    """The plan's picks on an H100 SXM: gate / up in one split (86 or 108
    column blocks), down in 3 splits (32 or 40 column blocks)."""
    d, f = _preset(preset)
    plan = fused_mlp_plan(d, f, *_tiles(d, f), 132)
    assert (plan.splits1, plan.splits2) == (1, 3)
    assert plan.blocks1 == f // GEMV_COLS and plan.blocks2 == d // GEMV_COLS


def test_fused_mlp_tiny_preset_is_refused_by_both_gates():
    """The tiny preset's d (64) is not a multiple of B11's group: the entry
    point's rules refuse it, and so does `fused_mlp_ok` on its int4 leaves
    (groups of 64), with the gate open."""
    d, f = _preset("tiny")
    assert fused_mlp_refusal(1, d, f, 64, 64, MlpPlan(1, 1, 1, 1, 1, 1)) is not None
    half = d // 2
    leaves = {k: {"w4t": torch.empty((2, 1, 1, half, f), dtype=torch.int8)}
              for k in ("wg", "wu", "w_down")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HANDSONVLM_FUSED_MLP", "1")
        assert not fused_mlp_ok(leaves, d, 1, 1)


D7, F7 = _preset("7b")
PLAN7 = fused_mlp_plan(D7, F7, 256, 256, 132)
# arguments hv_fused_mlp refuses: (b, d, f, bnf, bnd, plan)
REFUSED = {
    "no_rows": (0, D7, F7, 256, 256, PLAN7),
    "nine_rows": (ROWS + 1, D7, F7, 256, 256, PLAN7),
    "d_not_a_group": (1, D7 + 64, F7, 256, 256, PLAN7),
    "f_not_a_group": (1, D7, F7 + 64, 256, 256, PLAN7),
    "gate_tile_not_64": (1, D7, F7, 96, 256, PLAN7),
    "gate_tile_not_dividing_f": (1, D7, F7, 512, 256, PLAN7),
    "down_tile_not_dividing_d": (1, D7, F7, 256, 384, PLAN7),
    "nine_gate_up_splits": (1, D7, F7, 256, 256, PLAN7._replace(splits1=9, per1=4)),
    "gate_up_splits_miss_a_group": (1, D7, F7, 256, 256, PLAN7._replace(splits1=2, per1=15)),
    "down_split_past_the_groups": (1, D7, F7, 256, 256, PLAN7._replace(splits2=4, per2=29)),
    "xn_past_shared_memory": (ROWS, 16384, 4096, 256, 256,
                              MlpPlan(32, 1, 128, 128, 1, 32)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_fused_mlp_refusal_names_what_the_entry_point_refuses(case):
    refusal = fused_mlp_refusal(*REFUSED[case])
    assert isinstance(refusal, str) and refusal


def test_fused_mlp_shared_memory_constants_mirror_the_source():
    """The Python mirror's shared-memory sizes are the CUDA source's: the
    gate/up ring (stages of both weights' group and scales, two mbarriers
    each, 1 KB of alignment slack) and the cap."""
    src = (Path(handsonvlm_torch.__file__).parent / "csrc" / "fused_decode.cu").read_text()
    stages = int(re.search(r"constexpr int kUpStages = (\d+);", src).group(1))
    assert UP_SMEM_FIXED == stages * (2 * 64 * 128 + 2 * 4 * 128) + 2 * stages * 8 + 1024
    assert "constexpr int kSmemCap = 227 * 1024 - 1024;" in src and SMEM_CAP == 227 * 1024 - 1024
    assert "constexpr int kXnUnitRow = 8 * 4 * 8;" in src and XN_GROUP_ROW == 8 * 4 * 8
