"""Seeded weights, made on the device in a few large calls.

`make_weights(spec, seed, device)` returns {name: tensor} under the
program's state-dict names, in the layout and dtype the configuration
serves: bf16 matrices, or (quantize "int4") the packed int4 tiles and
group scales of the four fused projections and the int8 head, made as
data straight from the seed. The same call gives the same tensors, so the
reference remakes them after the program is freed instead of reading
anything the program holds.

Steering (the configuration's `hand_share`): residual coordinates 0 and 1
are written by no layer (row 0 and 1 of every o / down projection are
zero). Coordinate 0 of the embedding is STEER_C on a seeded set of trigger
ids (a share f = s / (1 - s) of the base vocabulary) and -STEER_C on
<hand_traj>; the head reads it for <hand_traj> alone (+STEER_U), so a
trigger token is followed by <hand_traj> and about s of the answer is
<hand_traj>. Coordinate 1 is STEER_C on every id and the head reads it for
</s> (-STEER_U), so </s> is never drawn and every answer runs its length.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

STEER_C, STEER_U = 16.0, 64.0
EOS_ID = 2
INT4_STD = 4.32  # std of a value uniform over -7..7
INT8_STD = 73.3  # std of a value uniform over -127..127


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from `seed` and tags, for the streams of one run."""
    text = ":".join(str(x) for x in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def _norm_like(name: str) -> bool:
    return (name.endswith("layernorm.weight") or name.endswith("norm.weight")
            or "layer_norm" in name or "layrnorm" in name)


def _shapes(cfg, quantize):
    from handsonvlm_torch.models.handsonvlm import HandsOnVLM

    with torch.device("meta"):
        model = HandsOnVLM(cfg, quantize=quantize)
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def _pack_int4(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 tensors of values in -7..7 -> the packed bytes of the
    program's int4 layout: low nibble lo + 8, high nibble hi."""
    return ((lo + 8).to(torch.uint8) | ((hi.to(torch.uint8) & 0x0F) << 4)).view(torch.int8)


@torch.no_grad()
def make_weights(spec, seed: int, device, steer: bool = True) -> Dict[str, torch.Tensor]:
    """`steer`: the generation cells' steering (a training cell, which
    draws nothing, takes the plain random weights)."""
    cfg = spec.cfg
    g = generator(seed, device, "weights")
    shapes = _shapes(cfg, spec.quantize)
    dt = cfg.pdtype
    out: Dict[str, torch.Tensor] = {}

    normal = [k for k, (s, d) in shapes.items()
              if d.is_floating_point and not k.startswith(("traj.", "projector."))
              and not _norm_like(k) and not k.endswith(("bias", ".gst", ".scale"))]
    total = sum(int(torch.Size(shapes[k][0]).numel()) for k in normal)
    flat = torch.randn(total, generator=g, device=device, dtype=dt).mul_(0.02)
    off = 0
    for k in normal:
        n = int(torch.Size(shapes[k][0]).numel())
        out[k] = flat[off:off + n].view(shapes[k][0])
        off += n

    for k, (s, d) in shapes.items():
        if k in out:
            continue
        if _norm_like(k) and k.endswith("weight"):
            out[k] = torch.ones(s, dtype=d, device=device)
        elif k.endswith("bias") and not k.startswith("traj."):
            out[k] = torch.zeros(s, dtype=d, device=device)
        elif k.startswith(("traj.", "projector.")):
            fan_in = shapes[k.rsplit(".", 1)[0] + ".weight"][0][1]
            bound = fan_in ** -0.5
            out[k] = (torch.rand(s, generator=g, device=device, dtype=torch.float32)
                      .mul_(2 * bound).sub_(bound).to(d))
        elif k.endswith(".w4t"):
            lo = torch.randint(-7, 8, s, generator=g, device=device, dtype=torch.int8)
            hi = torch.randint(-7, 8, s, generator=g, device=device, dtype=torch.int8)
            out[k] = _pack_int4(lo, hi)
            del lo, hi
        elif k.endswith(".gst"):
            out[k] = torch.rand(s, generator=g, device=device).mul_(0.5).add_(0.75).mul_(
                0.02 / INT4_STD)
        elif k == "llama.lm_head.w8":
            out[k] = torch.randint(-127, 128, s, generator=g, device=device, dtype=torch.int8)
        elif k == "llama.lm_head.scale":
            out[k] = torch.rand(s, generator=g, device=device).mul_(0.5).add_(0.75).mul_(
                0.02 / INT8_STD)
        else:
            raise KeyError(f"no rule to make {k} {s} {d}")
    if steer:
        _steer(out, spec, g)
    return out


def trigger_ids(spec, g: torch.Generator, device) -> torch.Tensor:
    base = spec.raw["vocab_size"] - 3  # ids 3 .. vocab_size - 1
    s = spec.hand_share
    n = int(round(base * s / (1.0 - s)))
    return torch.randperm(base, generator=g, device=device)[:n] + 3


@torch.no_grad()
def _steer(w: Dict[str, torch.Tensor], spec, g: torch.Generator) -> None:
    cfg = spec.cfg
    hand = cfg.hand_token_id
    emb = w["llama.embed_tokens.weight"]
    trig = trigger_ids(spec, g, emb.device)
    emb[:, 0] = 0.0
    emb[trig, 0] = STEER_C
    emb[hand, 0] = -STEER_C
    emb[:, 1] = STEER_C
    for i in range(cfg.llama.num_layers):  # no layer writes coordinates 0 and 1
        for name in ("self_attn.o_proj", "mlp.down_proj"):
            key = f"llama.layers.{i}.{name}.weight"
            if key in w:
                w[key][0:2] = 0.0
    for name in ("wo", "w_down"):
        key = f"llama.int4.{name}.gst"
        if key in w:  # tile 0 holds output columns 0 and 1: their scales 0
            w[key][:, 0, :, 0:2] = 0.0
    if "llama.lm_head.weight" in w:
        head = w["llama.lm_head.weight"]
        head[:, 0:2] = 0.0
        head[hand] = 0.0
        head[EOS_ID] = 0.0
        head[hand, 0] = STEER_U
        head[EOS_ID, 1] = -STEER_U
    else:
        w8, scale = w["llama.lm_head.w8"], w["llama.lm_head.scale"]
        w8[:, 0:2] = 0
        w8[hand] = 0
        w8[EOS_ID] = 0
        w8[hand, 0] = 127
        w8[EOS_ID, 1] = -127
        scale[hand] = STEER_U / 127.0
        scale[EOS_ID] = STEER_U / 127.0


def load_program_model(spec, weights: Dict[str, torch.Tensor]):
    """The program's model over the seeded weights (the tensors assigned,
    not copied)."""
    from handsonvlm_torch.models.handsonvlm import HandsOnVLM

    with torch.device("meta"):
        model = HandsOnVLM(spec.cfg, quantize=spec.quantize)
    model.load_state_dict(weights, assign=True, strict=True)
    return model.eval().requires_grad_(False)
