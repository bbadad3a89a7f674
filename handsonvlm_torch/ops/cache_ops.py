"""In-place block-aligned KV-cache compaction.

Port of `handsonvlm_tpu/ops/cache_ops.py`. Continuous batching
(serve/continuous.py) fragments the shared cache: every join burns a
prompt-bucket hole into every other row's plane, and the shared cursor
only resets when all slots idle. `gather_cache_blocks` (kernel B8) moves
each row's valid cache blocks toward the front so the cursor can be pulled
back.

The move granularity is the decode attention's block
(ops/decode_attention.pick_block_k): the engine computes per-row tables
(`build_row_table`) that keep every valid key's lane within its block and
the relative order of valid blocks, so the compacted sweep of kernels
B1/B6 sees bit-identical per-block inputs in identical order and a row's
logits are bit-equal across a compaction event.

Tables are left-moving (table[b, j] >= j), which makes the gather safe in
place: the CUDA kernel (`csrc/cache_ops.cu`) walks each row's blocks in
ascending order, and no second cache is allocated. A CUDA tensor launches
the kernel or raises; a CPU tensor runs `gather_cache_blocks_ref`.
`gather_cache_blocks.LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from handsonvlm_torch.ops._build import refuse_grad

_CHUNK_BYTES = 1 << 16  # bytes of one block moved by one thread block


def _check(c: torch.Tensor, table: torch.Tensor, block_k: int, seq_axis: int):
    if seq_axis not in (2, 3) or c.dim() != seq_axis + (3 if seq_axis == 2 else 1):
        raise ValueError(f"seq_axis {seq_axis} needs a (L, B, S, K, D) (2) or (L, B, K, S) "
                         f"(3) plane, got shape {tuple(c.shape)}")
    b, s = c.shape[1], c.shape[seq_axis]
    nk = s // block_k
    if block_k <= 0 or tuple(table.shape) != (b, nk):
        raise ValueError(f"table must be (B, S // block_k)=({b}, {nk}), got "
                         f"{tuple(table.shape)}")
    ids = torch.arange(nk, device=table.device)
    if bool(((table < ids) | (table >= nk)).any()):
        raise ValueError("table must be left-moving (table[b, j] >= j) with entries < "
                         "S // block_k")


def gather_cache_blocks_ref(c: torch.Tensor, table, *, block_k: int,
                            seq_axis: int = 2) -> torch.Tensor:
    """Plain PyTorch version of kernel B8: for each row b, gather the
    row's blocks by table[b] and copy them back over its first
    S // block_k blocks (c[:, b] is rewritten; returns c)."""
    table = torch.as_tensor(table).cpu()
    nk = table.shape[1]
    lanes = torch.arange(block_k)
    for b in range(c.shape[1]):
        row = table[b].long()
        if bool((row == torch.arange(nk)).all()):
            continue
        src = (row[:, None] * block_k + lanes).reshape(-1).to(c.device)
        plane = c[:, b]
        plane.narrow(seq_axis - 1, 0, nk * block_k).copy_(plane.index_select(seq_axis - 1, src))
    return c


def _launch(c: torch.Tensor, table: torch.Tensor, block_k: int, seq_axis: int) -> None:
    from handsonvlm_torch.ops._build import check, load_library

    if not c.is_contiguous():
        raise ValueError("the cache plane must be contiguous")
    table = table.to(device=c.device, dtype=torch.int32).contiguous()
    ell, b = c.shape[:2]
    es = c.element_size()
    if seq_axis == 2:
        rows, per_b, inner = ell * b, 1, c.shape[3] * c.shape[4]
    else:
        rows, per_b, inner = ell * b * c.shape[2], c.shape[2], 1
    row_bytes = c.shape[seq_axis] * inner * es
    block_bytes = block_k * inner * es
    n_chunks = -(-block_bytes // _CHUNK_BYTES)
    chunk_bytes = -(-block_bytes // n_chunks)
    vec16 = all(x % 16 == 0 for x in (c.data_ptr(), row_bytes, block_bytes, chunk_bytes))
    lib = load_library()
    with torch.cuda.device(c.device):
        status = lib.hv_gather_cache_blocks(
            c.data_ptr(), table.data_ptr(), rows, b, per_b, table.shape[1], row_bytes,
            block_bytes, chunk_bytes, n_chunks, int(vec16),
            torch.cuda.current_stream().cuda_stream)
    check(status, "gather_cache_blocks")
    gather_cache_blocks.LAUNCHES += 1


def gather_cache_blocks(c: torch.Tensor, table, *, block_k: int,
                        seq_axis: int = 2) -> torch.Tensor:
    """Move cache blocks per a left-moving per-row block table, in place.

    c:      (L, B, S, K, D) cache plane  (seq_axis=2; k/v, any dtype), or
            (L, B, K, S) scale plane     (seq_axis=3; int8-cache ks/vs).
    table:  (B, S // block_k) ints: for every destination block j of row b
            the SOURCE block index; table[b, j] >= j, and entries equal to
            j move nothing.

    Rewrites c so that, for every (b, j),
      c[:, b, j*bk:(j+1)*bk] = old c[:, b, table[b, j]*bk : +bk]   (seq_axis 2)
    and returns c. CUDA tensors run the Hopper kernel; CPU tensors the
    plain version."""
    table = torch.as_tensor(table)
    _check(c, table, block_k, seq_axis)
    if c.is_cuda:
        refuse_grad("gather_cache_blocks", c)
        _launch(c, table, block_k, seq_axis)
    elif c.device.type == "cpu":
        gather_cache_blocks_ref(c, table, block_k=block_k, seq_axis=seq_axis)
    else:
        raise ValueError(f"no block gather for device {c.device}")
    return c


gather_cache_blocks.LAUNCHES = 0


def count_removable_blocks(mask_row, pos: int, block_k: int) -> int:
    """Number of fully-invalid blocks of this row in [0, pos): the row's
    compaction headroom. The engine removes the MINIMUM across live rows
    from every row so the shared cursor shifts by one common multiple of
    block_k (see build_row_table's bit-equality argument)."""
    if pos <= 0:
        return 0
    nb = (pos - 1) // block_k + 1
    mpad = np.zeros(nb * block_k, bool)
    mpad[:min(pos, mask_row.shape[0])] = mask_row[:pos]
    return int((~mpad.reshape(nb, block_k).any(axis=1)).sum())


def build_row_table(mask_row, pos: int, block_k: int, nk: int, h: int):
    """Host-side compaction plan for ONE row's (S,) validity mask: delete
    the row's first `h` fully-invalid blocks in [0, pos), shifting every
    later block left to fill the gaps.

    Bit-equality argument (the engine's contract across a compaction
    event): the decode kernel's compacted sweep visits the row's VALID
    blocks in index order; deleting empty blocks changes valid blocks'
    INDICES but not one bit of any per-block (content, lane-mask) input,
    nor their order. The shared cursor shifts by exactly h * block_k —
    the same h for every live row — so every row's future writes land at
    lane offsets congruent to the uncompacted run's, grouping into blocks
    identically, forever. Entries are left-moving (a block shifts down by
    at most the number of empties below it), satisfying
    gather_cache_blocks's in-place contract.

    Returns (table (nk,) int32, new_mask (S,) bool). The caller must pass
    h <= count_removable_blocks(mask_row, pos, block_k).
    """
    table = np.arange(nk, dtype=np.int32)
    new_mask = np.zeros(mask_row.shape[0], bool)
    nb = 0 if pos <= 0 else (pos - 1) // block_k + 1
    mpad = np.zeros(nk * block_k, bool)
    mpad[:min(pos, mask_row.shape[0])] = mask_row[:pos]
    blocks = mpad.reshape(nk, block_k)
    occupied = blocks[:nb].any(axis=1)
    empties = np.flatnonzero(~occupied)
    if h > empties.shape[0]:
        raise ValueError(f"cannot remove {h} blocks, the row has {empties.shape[0]} empty")
    removed = set(empties[:h].tolist())
    dest = 0
    for sb in range(nb):
        if sb in removed:
            continue
        table[dest] = sb
        new_mask[dest * block_k:(dest + 1) * block_k] = blocks[sb]
        dest += 1
    return table, new_mask
