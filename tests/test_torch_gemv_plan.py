"""The GEMV's launch plan (csrc/gemv.cuh, B4a / B4b / B4c and B9's GEMV
route) on the CPU: for the tiny, 7B and 13B projections, int4 over the
tiled and the flat layout (the fused projections, and B4a's per-projection
matrices) and int8, the plan's splits fit one cluster and cover the
contraction once, its row tiles cover m, it does not change with m, and
the CUDA entry point's argument rules (mirrored in Python) accept it. The
kernels themselves run on the card (tests/test_torch_kernels.py)."""

import pytest

from handsonvlm_torch.config import get_config
from handsonvlm_torch.models.llama import int4_projection_shapes, projection_shapes
from handsonvlm_torch.ops.int8_matmul import (
    GEMV_COLS,
    GEMV_INT8_STAGE,
    GEMV_MAX_SPLITS,
    GEMV_ROWS,
    int4_gemv_plan,
    int4_gemv_refusal,
    int8_gemv_plan,
    int8_gemv_refusal,
    int4_group,
    pick_block_n,
    tiled_shapes,
)

ROWS = (1, 5, 8, 9, 127, 391)
N_SM = (132, 114)  # H100 SXM, H100 PCIe


def _cases():
    """(id, kind, din, dout): the int4 fused projections over the tiled and
    the flat layout (B4b, B4c), the per-projection matrices in the flat
    layout (B4a) and in int8 (B9), for the tiny, 7B and 13B presets."""
    out = []
    for preset in ("tiny", "7b", "13b"):
        cfg = get_config(preset).llama
        for proj, (din, dout) in int4_projection_shapes(cfg).items():
            out += [(f"{preset}-{proj}-{kind}", kind, din, dout) for kind in ("tiled", "flat")]
        for proj, (din, dout) in projection_shapes(cfg).items():
            out += [(f"{preset}-{proj}-{kind}", kind, din, dout) for kind in ("b4a", "int8")]
    return out


CASES = {c[0]: c[1:] for c in _cases()}


def _int4_geometry(kind, din, dout):
    """(NB, G, g/2, BN) as the wrappers see the weight: the tiled layout's
    own, or for a flat one the tile width `pick_block_n` gives."""
    if kind == "tiled":
        (_, nb, groups, half, bn), _ = tiled_shapes(din, dout, 1)
        return nb, groups, half, bn
    group = int4_group(din)
    groups, half = din // group, group // 2
    bn = pick_block_n(dout, groups * half)
    return dout // bn, groups, half, bn


@pytest.mark.parametrize("n_sm", N_SM)
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("case", list(CASES))
def test_gemv_plan_is_taken_by_the_entry_point(case, m, n_sm):
    kind, din, dout = CASES[case]
    if kind == "int8":
        plan = int8_gemv_plan(m, din, dout, n_sm)
        units, n = -(-din // GEMV_INT8_STAGE), dout
        assert plan.blocks * GEMV_COLS >= dout > (plan.blocks - 1) * GEMV_COLS
        refusal = int8_gemv_refusal(m, din, dout, plan.splits, plan.per * GEMV_INT8_STAGE)
        alone = int8_gemv_plan(1, din, dout, n_sm)
    else:
        nb, groups, half, bn = _int4_geometry(kind, din, dout)
        plan = int4_gemv_plan(m, nb, groups, bn, n_sm)
        units, n = groups, nb * bn
        # each BN tile's columns lie in whole column blocks of that tile
        assert plan.blocks % nb == 0
        cpt = plan.blocks // nb
        assert cpt * GEMV_COLS >= bn > (cpt - 1) * GEMV_COLS
        refusal = int4_gemv_refusal(m, nb, groups, half, bn, plan.splits, plan.per)
        alone = int4_gemv_plan(1, nb, groups, bn, n_sm)
    assert n == dout
    assert refusal is None, refusal
    # the splits: one cluster, every unit once, whatever m
    assert 1 <= plan.splits <= GEMV_MAX_SPLITS
    assert (plan.splits - 1) * plan.per < units <= plan.splits * plan.per
    assert plan[2:] == alone[2:]
    # the row tiles cover m
    assert plan.row_tiles * GEMV_ROWS >= m > (plan.row_tiles - 1) * GEMV_ROWS


@pytest.mark.parametrize("preset", ["7b", "13b"])
def test_gemv_flat_and_tiled_plans_agree(preset):
    """The flat layout of a fused int4 projection plans as the tiled one
    (the same column blocks and splits), so the two give the same bits."""
    for din, dout in int4_projection_shapes(get_config(preset).llama).values():
        tiled = int4_gemv_plan(5, *_pick(_int4_geometry("tiled", din, dout)), 132)
        flat = int4_gemv_plan(5, *_pick(_int4_geometry("flat", din, dout)), 132)
        assert tiled == flat


def _pick(geometry):
    nb, groups, _, bn = geometry
    return nb, groups, bn


# arguments the entry points refuse: (kind, arguments)
REFUSED = {
    "int4_nine_splits": ("int4", (1, 8, 32, 64, 512, 9, 4)),
    "int4_splits_miss_a_group": ("int4", (1, 8, 32, 64, 512, 4, 7)),
    "int4_split_past_the_groups": ("int4", (1, 8, 32, 64, 512, 5, 8)),
    "int4_tile_not_16": ("int4", (1, 8, 32, 64, 520, 4, 8)),
    "int4_group_of_8": ("int4", (1, 8, 32, 4, 512, 4, 8)),
    "int4_too_many_row_tiles": ("int4", (8 * 65535 + 1, 8, 32, 64, 512, 4, 8)),
    "int8_nine_splits": ("int8", (1, 4096, 4096, 9, 512)),
    "int8_split_not_a_stage": ("int8", (1, 4096, 4096, 4, 1000)),
    "int8_splits_miss_rows": ("int8", (1, 4096, 4096, 4, 960)),
    "int8_n_not_16": ("int8", (1, 4096, 4088, 4, 1024)),
    "int8_d_not_8": ("int8", (1, 4092, 4096, 4, 1024)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_gemv_refusal_names_what_the_entry_point_refuses(case):
    kind, args = REFUSED[case]
    refusal = (int4_gemv_refusal if kind == "int4" else int8_gemv_refusal)(*args)
    assert isinstance(refusal, str) and refusal
