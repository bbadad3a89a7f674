"""Weight-delta and consolidation tools over the port's checkpoints.

Port of `handsonvlm_tpu/convert/delta.py` (the reference's
llava/model/{make_delta,apply_delta,consolidate}.py: LLaVA / Vicuna
weights ship as deltas against the base LLaMA for licensing reasons;
consolidate re-saves a checkpoint as a single artifact) over the port's
layouts (`core.checkpoint`): state dicts, flat or nested, of tensors.

- ``make_delta`` = target - base per leaf; ``apply_delta`` = delta + base,
  its exact inverse; both in f32, each leaf cast back to its dtype;
- leaves missing from the base (projector, traj head, vision tower) ride
  along verbatim;
- a resized embedding or head (target vocab 32101 vs base 32000) subtracts
  or adds only the overlapping top-left corner (apply_delta.py:29-33): the
  rows tokenizer surgery added ride along at full value;
- ``consolidate`` loads any layout the builder reads (a trainer output, a
  params export, an adapter directory, an HF checkpoint) and saves its
  model state as one params export.

  python -m handsonvlm_torch.convert.delta make-delta --base B --src T --out D
  python -m handsonvlm_torch.convert.delta apply-delta --base B --src D --out T
  python -m handsonvlm_torch.convert.delta consolidate --src S --dst D [--preset 7b]
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def _flat(tree: Any, prefix: Tuple = ()) -> Dict[Tuple, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _corner_op(t: torch.Tensor, b: torch.Tensor, op) -> torch.Tensor:
    """op on the overlapping top-left corner (a resized embed / lm_head)."""
    out = t.clone()
    sl = tuple(slice(0, min(ts, bs)) for ts, bs in zip(t.shape, b.shape))
    out[sl] = op(t[sl], b[sl])
    return out


def _combine(target_tree: Any, base_tree: Any, op) -> Any:
    base = _flat(base_tree)

    def visit(key, t):
        if isinstance(t, dict):
            return {k: visit(key + (k,), v) for k, v in t.items()}
        b = base.get(key)
        if b is None:
            return t  # not in the base (projector / traj / vision): verbatim
        t32, b32 = t.float(), b.to(t.device).float()
        if t.shape == b.shape:
            return op(t32, b32).to(t.dtype)
        if t.dim() != b.dim():
            raise ValueError(f"{'.'.join(map(str, key))}: rank mismatch "
                             f"{tuple(t.shape)} vs {tuple(b.shape)}")
        return _corner_op(t32, b32, op).to(t.dtype)

    return visit((), target_tree)


def make_delta(target: Any, base: Any) -> Any:
    """delta = target - base (leaf-wise; the corner rule for a resized vocab)."""
    return _combine(target, base, lambda t, b: t - b)


def apply_delta(delta: Any, base: Any) -> Any:
    """target = delta + base, the exact inverse of make_delta."""
    return _combine(delta, base, lambda t, b: t + b)


def consolidate(src_dir: str, dst_dir: str, preset: str = "7b"):
    """Re-save any layout the builder reads as a single params export;
    returns the config."""
    from handsonvlm_torch.core.checkpoint import save_params
    from handsonvlm_torch.infer.builder import load_pretrained_model

    model, cfg, _tok = load_pretrained_model(src_dir, preset, device="cpu")
    save_params(dst_dir, model.state_dict())
    return cfg


def main(argv=None):
    import argparse

    from handsonvlm_torch.core.checkpoint import restore_params, save_params

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd in ("make-delta", "apply-delta"):
        sp = sub.add_parser(cmd)
        sp.add_argument("--base", required=True, help="base params dir")
        sp.add_argument("--src", required=True,
                        help="target model dir (make) / delta dir (apply)")
        sp.add_argument("--out", required=True)
    sp = sub.add_parser("consolidate")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)
    sp.add_argument("--preset", default="7b")
    args = p.parse_args(argv)

    if args.cmd == "consolidate":
        consolidate(args.src, args.dst, args.preset)
        return
    base = restore_params(args.base)
    src = restore_params(args.src)
    fn = make_delta if args.cmd == "make-delta" else apply_delta
    save_params(args.out, fn(src, base))


if __name__ == "__main__":
    main()
