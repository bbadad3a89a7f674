"""Seeded training inputs, which the harness hands to the program and the
reference alike: each step's batch and CVAE noise, and the adapters'
starting values."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hov_bench.core.weights import derive, generator

IGNORE = -100
IMAGE = -200
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def lora_shapes(conf: dict) -> Dict[str, Tuple[int, int]]:
    """(din, dout) of each adapted projection, from a configuration file."""
    d, f = conf["hidden_size"], conf["intermediate_size"]
    h, k = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // h
    return {"wq": (d, h * hd), "wk": (d, k * hd), "wv": (d, k * hd), "wo": (h * hd, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def lora_start(conf: dict, r: int, seed: int, device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each target's a (L, din, r) ~ N(0, 0.02) and b (L, r, dout) = 0, f32,
    the a's from one draw."""
    L = conf["num_hidden_layers"]
    shapes = lora_shapes(conf)
    total = sum(L * din * r for din, _ in shapes.values())
    flat = torch.randn(total, generator=generator(seed, device, "lora"), device=device).mul_(0.02)
    out, off = {}, 0
    for t in TARGETS:
        din, dout = shapes[t]
        n = L * din * r
        out[t] = (flat[off:off + n].view(L, din, r),
                  torch.zeros((L, r, dout), device=device))
        off += n
    return out


def batch(conf: dict, mix: dict, seed: int, step: int, device, dtype) -> Tuple[dict, torch.Tensor]:
    """Step `step`'s batch: `batch` samples of `rows` spliced rows each. A
    sample is BOS, the image sentinel, seeded text ids up to the answer, and
    an answer of `answer_tokens` ids holding `hand_tokens` <hand_traj>
    tokens, labelled alone; 10 seeded frames tiled into the clip's slots,
    future hands uniform in [0, 1), both hands valid. Returns the batch and
    its CVAE noise (B * 2 * 4, latent) in `dtype`."""
    hv = conf["handsonvlm"]
    b, rows = int(mix["batch"]), int(mix["rows"])
    nv = hv["num_frames"] + (hv["vision"]["image_size"] // hv["vision"]["patch_size"]) ** 2
    t = rows - nv + 1
    a, nh = int(mix.get("answer_tokens", 16)), int(mix.get("hand_tokens", 4))
    rng = np.random.default_rng(derive(seed, "batch", step))
    ids = rng.integers(3, conf["vocab_size"], size=(b, t))
    ids[:, 0], ids[:, 1] = 1, IMAGE
    hand_at = t - a + np.arange(1, nh + 1) * (a // (nh + 1))
    ids[:, hand_at] = hv["hand_token_id"]
    ids[:, -1] = 2
    labels = np.full((b, t), IGNORE)
    labels[:, t - a:] = ids[:, t - a:]
    u = int(mix["frames"]["unique"])
    size = hv["vision"]["image_size"]
    g = generator(seed, device, "frames", step)
    images = torch.randn((b, u, 3, size, size), generator=g, device=device).to(dtype)
    frame_map = np.tile(np.arange(u), hv["num_frames"] // u)
    eps = torch.randn((b * 2 * nh, hv["traj"]["latent_dim"]), generator=g, device=device).to(dtype)
    out = {"input_ids": torch.as_tensor(ids, device=device),
           "attn_mask": torch.ones((b, t), dtype=torch.bool, device=device),
           "image": images, "frame_map": torch.as_tensor(frame_map, device=device),
           "labels": torch.as_tensor(labels, device=device),
           "future_hands": torch.as_tensor(rng.uniform(size=(b, 2, 5, 2)), device=device,
                                           dtype=torch.float32),
           "future_valid": torch.ones((b, 2), device=device)}
    return out, eps
