"""The plain fp32 QLoRA steps the trained state is held to.

The teacher-forced loss of HandsOnVLM (the text's cross-entropy over the
labelled targets, plus the CVAE's reconstruction and KL terms on the
hidden states that predict the first four <hand_traj> labels, whose input
embeddings carry the ground-truth waypoints' encodings), differentiated by
autograd with respect to the LoRA adapters and the weights the recipe
trains besides (the projector and the CVAE head), then clipped by the
global norm and stepped by AdamW. Those weights are held in the dtype the
configuration states (bf16), so each step's update is rounded to it, as
a model that stores them in that dtype keeps them. The decoder runs layer by layer under
activation checkpointing, its int4 weights unpacked inside each layer, so
the f32 model never sits on the card whole.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from hov_bench.reference.model import Reference, hand_encoding, rms_norm, rotary

IGNORE = -100
# an adapter's target -> the projection of the layer it adds to
PROJ = {"wq": "q", "wk": "k", "wv": "v", "wo": "o", "w_gate": "gate", "w_up": "up",
        "w_down": "down"}


def _block(ref: Reference, i: int, x: torch.Tensor, lora, scale: float) -> torch.Tensor:
    """Layer i over a batch x (B, T, D) of full causal sequences; `lora`
    maps a projection ("q", ..., "down") to its adapter (a, b)."""
    d = ref.d
    lw = ref.layer(i)
    b, t, _ = x.shape
    hd, H, K, eps = d["head_dim"], d["heads"], d["kv_heads"], d["eps"]
    pos = torch.arange(t, device=x.device)

    def proj(v, n):
        y = ref.mm(v, lw[n])
        if n in lora:
            a, bb = lora[n]
            y = y + (v @ a[i]) @ bb[i] * scale  # the f32 adapters, in every mode
        return y

    h = rms_norm(x, lw["ln1"], eps)
    q = torch.stack([rotary(r, pos, d["theta"]) for r in proj(h, "q").view(b, t, H, hd)])
    k = torch.stack([rotary(r, pos, d["theta"]) for r in proj(h, "k").view(b, t, K, hd)])
    v = proj(h, "v").view(b, t, K, hd)
    rep = H // K
    k = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)  # (B, H, D, T)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)  # (B, H, T, D)
    s = ref.mm(q.transpose(1, 2), k.contiguous()) / math.sqrt(hd)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = ref.mm(p, v).transpose(1, 2).reshape(b, t, H * hd)
    x = x + proj(o, "o")
    h = rms_norm(x, lw["ln2"], eps)
    return x + proj(F.silu(proj(h, "gate")) * proj(h, "up"), "down")


def loss(ref: Reference, lora: dict, scale: float, batch: dict, eps: torch.Tensor,
         weights: dict, parts: bool = False):
    """The total loss of one batch (text CE + hoi_lambda x (traj + KL));
    with `parts`, a dict of the total and its three terms."""
    d, w = ref.d, ref.w
    ids, labels = batch["input_ids"].cpu().numpy(), batch["labels"].cpu().numpy()
    fh = batch["future_hands"].float()[:, :, 1:]  # (B, 2, 4, 2)
    valid = batch["future_valid"].float()
    hand = d["hand_id"]
    rows, tgt = [], []
    fmap = batch["frame_map"].cpu().numpy()
    with torch.no_grad():  # CLIP is frozen
        feats = [ref.clip_features(batch["image"][i]) for i in range(ids.shape[0])]
    vis = [ref.project_pool(f, fmap) for f in feats]
    for i in range(ids.shape[0]):
        e = ref.embed[torch.as_tensor(np.where(ids[i] < 0, 0, ids[i]), device=ref.embed.device)]
        hands = np.nonzero(ids[i] == hand)[0]
        n = fh.shape[2]
        add = torch.zeros_like(e)
        for k, p in enumerate(hands[:n]):
            add[p] = hand_encoding(fh[i, :, k], e.shape[1]) * (len(hands) / n)
        e = e + add
        s = int(np.nonzero(ids[i] < 0)[0][0])
        rows.append(torch.cat([e[:s], vis[i], e[s + 1:]]))
        lab = np.concatenate([labels[i, :s], np.full(vis[i].shape[0], IGNORE), labels[i, s + 1:]])
        tgt.append(np.concatenate([lab[1:], [IGNORE]]))  # position p predicts label p + 1
    x = torch.stack(rows)
    for i in range(d["layers"]):
        x = torch.utils.checkpoint.checkpoint(_block, ref, i, x, lora, scale, use_reentrant=False)
    x = ref.final(x)
    tgt = np.stack(tgt)
    bi, pi = np.nonzero(tgt != IGNORE)
    logits = ref.logits(x[bi, pi])
    t = torch.as_tensor(tgt[bi, pi], device=x.device)
    text = -torch.log_softmax(logits, -1).gather(1, t[:, None]).sum() / len(t)

    conds = []
    for i in range(x.shape[0]):
        at = np.nonzero(tgt[i] == hand)[0][: fh.shape[2]]
        conds.append(x[i, torch.as_tensor(at, device=x.device)].reshape(len(at), -1, 2)
                     .permute(2, 0, 1))  # (2 hands, 4, D / 2)
    cond = torch.stack(conds).reshape(-1, x.shape[-1] // 2)
    gt = fh.reshape(-1, 2)

    def lin(v, n):
        return v @ w[n + ".weight"].float().t() + w[n + ".bias"].float()

    h = F.elu(lin(torch.cat([gt, cond], -1), "traj.enc_MLP.0"))
    mean, logvar = lin(h, "traj.linear_means"), lin(h, "traj.linear_log_var")
    z = mean + eps.float() * torch.exp(0.5 * logvar)
    recon = ref.cvae_decode(cond, z)
    rec = ((recon - gt) ** 2).sum(1).reshape(fh.shape[0], 2, -1)
    kld = -0.5 * (1 + logvar - mean ** 2 - torch.exp(logvar)).sum(1)
    traj = weights["lambda_traj"] * (rec.sum(-1) * valid).sum()
    kl = weights["lambda_traj_kl"] * kld.sum() * valid.sum()
    total = text + weights["hoi_lambda"] * (traj + kl)
    if parts:
        return {"loss": total, "text_loss": text, "traj_loss": traj, "traj_kl_loss": kl}
    return total


def qlora_steps(ref: Reference, start: Dict[str, tuple], scale: float, batches: List[tuple],
                hp: dict, weights: dict, trained: Sequence[str] = ()) -> dict:
    """AdamW steps (clipped by the global norm) from the adapters `start`
    and the weights named `trained` in `ref.w` over `batches` [(batch,
    eps)]. Returns each step's loss, each step's per-leaf gradient norms
    (as the optimizer gets them, after the clip), and each leaf's change
    over all the steps."""
    leaves = {f"{t}.{ab}": p.detach().clone().requires_grad_(True)
              for t, pair in start.items() for ab, p in zip("ab", pair)}
    lora = {PROJ[t]: (leaves[f"{t}.a"], leaves[f"{t}.b"]) for t in start}
    held = {n: ref.w[n].dtype for n in trained}
    first = {}
    for n in trained:
        leaves[n] = ref.w[n].detach().float().clone().requires_grad_(True)
        first[n] = leaves[n].detach().clone()
        ref.w[n] = leaves[n]
    mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    b1, b2, e, lr = 0.9, 0.999, 1e-8, float(hp["lr"])
    out = {"loss": [], "grad": []}
    for step, (batch, eps) in enumerate(batches, start=1):
        total = loss(ref, lora, scale, batch, eps, weights)
        grads = torch.autograd.grad(total, list(leaves.values()))
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        clip = min(1.0, float(hp["max_grad_norm"]) / float(norm)) if norm >= hp["max_grad_norm"] else 1.0
        out["loss"].append(float(total.detach()))
        gd = {}
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                g = g * clip
                gd[k] = float(g.norm())
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                u = (mu[k] / (1 - b1 ** step)) / (torch.sqrt(nu[k] / (1 - b2 ** step)) + e)
                p -= lr * u
                if k in held:
                    p.copy_(p.to(held[k]).float())
        out["grad"].append(gd)
    with torch.no_grad():
        out["change"] = {f"{t}.{ab}": float((leaves[f"{t}.{ab}"] - p).norm())
                         for t, pair in start.items() for ab, p in zip("ab", pair)}
        out["change"].update({n: float((leaves[n] - first[n]).norm()) for n in trained})
    return out
