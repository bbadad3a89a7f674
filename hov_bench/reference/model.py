"""Plain fp32 HandsOnVLM: the reference the served and trained outputs are
held to.

Written from the published description (HandsOnVLM, arXiv 2412.13187, over
a LLaMA-family decoder: CLIP ViT-L/14 penultimate patch features, a linear
projector, temporal_spatial_pool to T + S tokens, the tokens spliced at the
image sentinel, RMSNorm / rotary / GQA / SwiGLU layers, the CVAE head fed
by the <hand_traj> hidden state, whose waypoint is fed back as a
sinusoidal encoding), in plain torch operations and float32 with TF32 off.
It imports nothing of the program: it reads the seeded weights the harness
makes (bf16 tensors, or the packed int4 tiles and the int8 head, which it
unpacks itself) and the token ids, frames and draws the harness hands both
sides.

`mode="fp8"` is the check's control: the same computation with every
matrix product's activations, and the bf16 weights, rounded to float8
e4m3 (per row of activations, per output column of weights): the
precision one step below the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (amax / 448), returned in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def unpack_int4_tiled(w4t: torch.Tensor, gst: torch.Tensor) -> torch.Tensor:
    """One layer of the tiled int4 layout, w4t (NB, G, g/2, BN) int8 bytes
    and gst (NB, G, BN) f32 -> the (din, dout) f32 weight. Byte r of a
    group holds row r (low nibble, biased by 8) and row r + g/2 (high
    nibble, two's complement); column j of tile b is output b * BN + j."""
    b = w4t.to(torch.int32)  # sign-extended, so b >> 4 is the signed high nibble
    lo = (b & 0x0F) - 8
    hi = b >> 4
    q = torch.cat([lo, hi], dim=2).float()  # (NB, G, g, BN)
    w = q * gst.float()[:, :, None, :]
    nb, groups, g, bn = w.shape
    return w.permute(1, 2, 0, 3).reshape(groups * g, nb * bn)


def quantize_kv_int8(x: torch.Tensor) -> torch.Tensor:
    """(..., D) rows -> int8 with one scale a row (amax / 127, round half
    to even, clip to 127), returned dequantized in f32."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / sc), -127, 127) * sc


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rotary(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D), positions (T,): rotate-half rotary embedding."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cat([ang, ang], -1).cos()[:, None], torch.cat([ang, ang], -1).sin()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def hand_encoding(wp: torch.Tensor, dim: int) -> torch.Tensor:
    """A waypoint (2 hands, 2) -> its (dim,) sinusoidal encoding: per hand
    [sin(x f), cos(y f), sin(x f), cos(y f)] over f = 10000^(-2i/c), c =
    dim / 4, the two hands interleaved element by element."""
    c = dim // 4
    f = 1.0 / 10000.0 ** (torch.arange(0, c, 2, device=wp.device, dtype=torch.float32) / c)
    per = [torch.cat([torch.sin(wp[h, 0] * f), torch.cos(wp[h, 1] * f),
                      torch.sin(wp[h, 0] * f), torch.cos(wp[h, 1] * f)]) for h in range(2)]
    return torch.stack(per, dim=-1).reshape(dim)


class Reference:
    """The model over the seeded weights `w` ({name: tensor}, the
    harness's names), its dims read from the config dict `dims`."""

    def __init__(self, w: Dict[str, torch.Tensor], dims: dict, mode: str = "f32",
                 kv_int8: bool = False, resident: bool = True):
        no_tf32()
        self.w, self.d, self.mode, self.kv_int8 = w, dims, mode, kv_int8
        self.L = dims["layers"]
        self.int4 = "llama.int4.wqkv.w4t" in w
        self._layers: Optional[List[dict]] = None
        emb = w["llama.embed_tokens.weight"].float()
        self.embed = emb
        if "llama.lm_head.weight" in w:
            head = w["llama.lm_head.weight"].float()
        else:
            head = w["llama.lm_head.w8"].float() * w["llama.lm_head.scale"].float()[:, None]
        self.head = self._wq(head.t().contiguous())
        if resident:
            self._layers = [self.layer(i) for i in range(self.L)]

    # -- weights ------------------------------------------------------------

    def _wq(self, m: torch.Tensor) -> torch.Tensor:
        """A (din, dout) f32 weight as the mode computes with it."""
        return fp8_round(m, dim=0) if self.mode == "fp8" else m

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.mode == "fp8" else x

    def mm(self, x, m):
        return self._act(x) @ m

    def layer(self, i: int) -> dict:
        """Layer i's weights as (din, dout) f32 matrices and its norms."""
        if self._layers is not None:
            return self._layers[i]
        w, d = self.w, self.d
        hd, H, K = d["head_dim"], d["heads"], d["kv_heads"]
        out = {"ln1": w[f"llama.layers.{i}.input_layernorm.weight"].float(),
               "ln2": w[f"llama.layers.{i}.post_attention_layernorm.weight"].float()}
        if self.int4:
            def tiled(name):
                return unpack_int4_tiled(w[f"llama.int4.{name}.w4t"][i],
                                         w[f"llama.int4.{name}.gst"][i])
            qkv = tiled("wqkv")
            out["q"], out["k"], out["v"] = qkv.split([H * hd, K * hd, K * hd], dim=1)
            out["o"] = tiled("wo")
            out["gate"], out["up"] = tiled("wgu").chunk(2, dim=1)
            out["down"] = tiled("w_down")
            return out  # int4 weights stay as stated in every mode
        p = f"llama.layers.{i}."
        names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                 "down": "mlp.down_proj"}
        for k, n in names.items():
            out[k] = self._wq(w[p + n + ".weight"].float().t().contiguous())
        return out

    # -- vision -------------------------------------------------------------

    def visual_tokens(self, frames: torch.Tensor, frame_map: np.ndarray) -> torch.Tensor:
        """Unique frames (U, 3, H, W) and the slot map (num_frames,) ->
        the (T + S, hidden) visual tokens: CLIP's penultimate patch
        features, projected, T temporal means and 4 keyframes 2x2-pooled."""
        return self.project_pool(self.clip_features(frames), frame_map)

    def clip_features(self, frames: torch.Tensor) -> torch.Tensor:
        """Unique frames (U, 3, H, W) -> CLIP's penultimate patch features
        (U, S, width)."""
        w, d = self.w, self.d
        v = "vision."
        x = frames.float()
        pw = w[v + "embeddings.patch_embedding.weight"].float()
        if self.mode == "fp8":
            x, pw = fp8_round(x.flatten(1)).view_as(x), fp8_round(pw.flatten(1)).view_as(pw)
        x = F.conv2d(x, pw, stride=d["patch"]).flatten(2).transpose(1, 2)
        u, _, width = x.shape
        cls = w[v + "embeddings.class_embedding"].float().expand(u, 1, width)
        x = torch.cat([cls, x], 1) + w[v + "embeddings.position_embedding.weight"].float()
        eps = d["vision_eps"]
        x = layer_norm(x, w[v + "pre_layrnorm.weight"].float(), w[v + "pre_layrnorm.bias"].float(), eps)
        heads = d["vision_heads"]
        for i in range(d["vision_layers_run"]):
            p = f"{v}encoder.layers.{i}."

            def lin(t, n):
                return self.mm(t, self._wq(w[p + n + ".weight"].float().t())) + w[p + n + ".bias"].float()

            h = layer_norm(x, w[p + "layer_norm1.weight"].float(), w[p + "layer_norm1.bias"].float(), eps)
            q, k, vv = (lin(h, f"self_attn.{n}_proj").view(u, -1, heads, width // heads).transpose(1, 2)
                        for n in ("q", "k", "v"))
            a = torch.softmax(self.mm(q, k.transpose(-1, -2).contiguous()) / math.sqrt(width // heads), -1)
            o = self.mm(a, vv).transpose(1, 2).reshape(u, -1, width)
            x = x + lin(o, "self_attn.out_proj")
            h = layer_norm(x, w[p + "layer_norm2.weight"].float(), w[p + "layer_norm2.bias"].float(), eps)
            h = lin(h, "mlp.fc1")
            x = x + lin(h * torch.sigmoid(1.702 * h), "mlp.fc2")
        return x[:, 1:]

    def project_pool(self, feats: torch.Tensor, frame_map: np.ndarray) -> torch.Tensor:
        """Patch features (U, S, width) -> the (T + S, hidden) visual tokens."""
        w = self.w
        tok = self.mm(feats, self._wq(w["projector.weight"].float().t())) + w["projector.bias"].float()
        tok = tok[torch.as_tensor(np.asarray(frame_map), device=tok.device).long()]  # (T, S, D)
        t, s, dim = tok.shape
        g = int(round(s ** 0.5))
        sel = np.round(np.linspace(0, t - 1, 4)).astype(int)
        key = tok[torch.as_tensor(sel, device=tok.device)].reshape(4, g // 2, 2, g // 2, 2, dim)
        return torch.cat([tok.mean(1), key.mean(dim=(2, 4)).reshape(-1, dim)], 0)

    # -- decoder ------------------------------------------------------------

    def embed_prompt(self, ids: np.ndarray, visual: torch.Tensor) -> torch.Tensor:
        """Token ids with one image sentinel (< 0) -> the spliced rows."""
        ids = np.asarray(ids)
        s = int(np.nonzero(ids < 0)[0][0])
        dev = self.embed.device
        pre = self.embed[torch.as_tensor(ids[:s], device=dev)]
        post = self.embed[torch.as_tensor(ids[s + 1:], device=dev)]
        return torch.cat([pre, visual, post], 0)

    def attn(self, q, k, v, causal_from: Optional[int]):
        """q (T, H, D) over k, v (S, K, D); `causal_from`: the position of
        q's first row among the keys (causal), or None for all keys."""
        d = self.d
        rep = d["heads"] // d["kv_heads"]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = self.mm(q.transpose(0, 1), k.permute(1, 2, 0).contiguous()) / math.sqrt(q.shape[-1])
        if causal_from is not None:
            t, n = q.shape[0], k.shape[0]
            allowed = (torch.arange(n, device=q.device)[None, :]
                       <= torch.arange(t, device=q.device)[:, None] + causal_from)
            s = s.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(s, -1)
        return self.mm(p, v.transpose(0, 1)).transpose(0, 1)

    def block(self, i: int, x: torch.Tensor, pos: torch.Tensor, cache: dict, lora=None):
        """Layer i over rows x (T, D) at positions `pos`, appending its keys
        and values to `cache` (lists per layer); the rows attend causally
        over the cache. With `kv_int8`, rows after the prompt (`cache
        ["prefilled"]` set) attend over the int8-rounded keys and values."""
        d = self.d
        lw = self.layer(i)
        hd, H, K, eps = d["head_dim"], d["heads"], d["kv_heads"], d["eps"]

        def proj(t, n):
            y = self.mm(t, lw[n])
            if lora is not None and n in lora:
                a, b, scale = lora[n]
                y = y + (t @ a[i]) @ b[i] * scale
            return y

        h = rms_norm(x, lw["ln1"], eps)
        q = rotary(proj(h, "q").view(-1, H, hd), pos, d["theta"])
        k = rotary(proj(h, "k").view(-1, K, hd), pos, d["theta"])
        v = proj(h, "v").view(-1, K, hd)
        ks, vs = cache.setdefault("k", [[] for _ in range(self.L)]), cache.setdefault(
            "v", [[] for _ in range(self.L)])
        ks[i].append(k)
        vs[i].append(v)
        kk, vv = torch.cat(ks[i]), torch.cat(vs[i])
        if self.kv_int8 and cache.get("prefilled"):
            kk, vv = quantize_kv_int8(kk), quantize_kv_int8(vv)
        start = kk.shape[0] - x.shape[0]
        o = self.attn(q, kk, vv, start).reshape(x.shape[0], H * hd)
        x = x + proj(o, "o")
        h = rms_norm(x, lw["ln2"], eps)
        return x + proj(F.silu(proj(h, "gate")) * proj(h, "up"), "down")

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.w["llama.norm.weight"].float(), self.d["eps"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.mm(h, self.head)

    # -- trajectory head ------------------------------------------------------

    def cvae_decode(self, cond: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        w = self.w
        h = torch.cat([z, cond], -1) @ w["traj.dec_MLP.0.weight"].float().t() + w["traj.dec_MLP.0.bias"].float()
        return F.elu(h) @ w["traj.dec_MLP.2.weight"].float().t() + w["traj.dec_MLP.2.bias"].float()

    def waypoint(self, hidden: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The final hidden (D,) at a position and the step's latent (2,
        latent) -> the (2 hands, 2) waypoint: each hand's condition is its
        half of the hidden, the two interleaved element by element."""
        cond = hidden.reshape(-1, 2).t()
        return self.cvae_decode(cond, z)

    # -- a served request, teacher-forced through a cache of its own ---------

    def serve(self, ids, visual, tokens: List[int], zs: torch.Tensor, hand_id: int):
        """Replay one served request: prefill the prompt, then feed each
        served token (with its waypoint's encoding when it is <hand_traj>)
        as the program's decode does. Returns the logits (n, V) that
        predicted the n served tokens and the waypoints (n, 2, 2) decoded
        with each step's latent `zs[j]`."""
        x = self.embed_prompt(ids, visual)
        p = x.shape[0]
        cache: dict = {}
        pos = torch.arange(p, device=x.device)
        for i in range(self.L):
            x = self.block(i, x, pos, cache)
        cache["prefilled"] = True
        h = self.final(x[-1:])
        logits, wps = [], []
        for j, tok in enumerate(tokens):
            logits.append(self.logits(h)[0])
            wps.append(self.waypoint(h[0], zs[j]))
            if j == len(tokens) - 1:
                break
            e = self.embed[tok]
            if tok == hand_id:
                e = e + hand_encoding(wps[-1], e.shape[0])
            x = e[None]
            pos = torch.tensor([p + j], device=x.device)
            for i in range(self.L):
                x = self.block(i, x, pos, cache)
            h = self.final(x)
        return torch.stack(logits), torch.stack(wps)


def dims_of(conf: dict) -> dict:
    """The reference's dims from a configuration file's dict."""
    hv, v = conf["handsonvlm"], conf["handsonvlm"]["vision"]
    heads = conf["num_attention_heads"]
    return {"layers": conf["num_hidden_layers"], "heads": heads,
            "kv_heads": conf["num_key_value_heads"],
            "head_dim": conf.get("head_dim") or conf["hidden_size"] // heads,
            "eps": float(conf["rms_norm_eps"]), "theta": float(conf["rope_theta"]),
            "patch": v["patch_size"], "vision_heads": v["num_heads"],
            "vision_eps": float(v["layer_norm_eps"]),
            "vision_layers_run": v["num_layers"] + v["select_layer"] + 1,
            "hand_id": hv["hand_token_id"], "latent": hv["traj"]["latent_dim"],
            "z_scale": float(hv["traj"]["z_scale"])}


def draws(seed: int, steps: int, latent: int, z_scale: float):
    """A request's per-step draws as its seed gives them: a generator
    seeded with the request's seed yields, for each step in order, one
    uniform (the token draw) and then 2 x latent normals (x z_scale).
    Returns the uniforms (steps,) and the latents (steps, 2, latent)."""
    g = torch.Generator().manual_seed(seed)
    us, zs = [], []
    for _ in range(steps):
        us.append(torch.rand((), generator=g))
        zs.append(z_scale * torch.randn((2, latent), generator=g))
    return torch.stack(us), torch.stack(zs)


def nucleus_cdf(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """(n, V) logits -> (n, V) float64 CDFs, over the ids in order, of
    softmax(logits / temperature) cut to its top-p nucleus (the most likely
    ids whose mass before them is under top_p) and renormalised. A token t
    is drawn by a uniform u when cdf[t - 1] <= u < cdf[t]."""
    p = torch.softmax(logits.double() / temperature, -1)
    srt, order = torch.sort(p, -1, descending=True)
    keep = torch.zeros_like(p, dtype=torch.bool).scatter_(-1, order, (srt.cumsum(-1) - srt) < top_p)
    q = torch.where(keep, p, torch.zeros_like(p))
    return (q / q.sum(-1, keepdim=True)).cumsum(-1)


def draw_gaps(cdf: torch.Tensor, tokens: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """How far each step's uniform lies outside the CDF interval of the
    token drawn there (0 where the token is the one the uniform draws)."""
    hi = cdf.gather(1, tokens[:, None])[:, 0]
    lo = torch.where(tokens > 0, cdf.gather(1, (tokens - 1).clamp(min=0)[:, None])[:, 0],
                     torch.zeros_like(hi))
    u = us.double().to(cdf.device)
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)


def draw_tokens(cdf: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """The token each step's uniform draws from its CDF."""
    u = us.double().to(cdf.device)[:, None]
    return torch.searchsorted(cdf, u, right=True)[:, 0].clamp(max=cdf.shape[1] - 1)
