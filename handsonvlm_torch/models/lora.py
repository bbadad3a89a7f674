"""LoRA adapters for the LLaMA decoder.

Port of `handsonvlm_tpu/models/lora.py`: the reference's `--lora_enable`
fine-tuning (r=128, alpha=256 over every decoder projection) as a separate
stacked tree applied inside the layer computation, the low-rank path on the
activations and never a merged weight, plus `merge_lora` for export.

The adapters keep the JAX package's layout: for each target `a` (L, din, r)
and `b` (L, r, dout), f32 master weights, held by a `LoRA` module whose
`scale` = alpha / r is a buffer (a constant, not a parameter). A layer reads
`LoRA.layer(i)`, views of row i, so the gradients land in the stacked
parameters.

The first-stage product x @ a runs through the registered op
`handsonvlm_torch::lora_u`, which the `save_lora` remat policy
(models/llama.py) recognises, as the JAX package names it with
`checkpoint_name(..., "lora_u")`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from handsonvlm_torch.config import LlamaConfig

# bf16 adapter compute (master weights stay f32), as the JAX package reads it
LORA_COMPUTE_BF16 = os.environ.get("HANDSONVLM_LORA_BF16", "0") == "1"

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

_SHAPES = {
    "wq": ("d", "qh"), "wk": ("d", "kh"), "wv": ("d", "kh"), "wo": ("qh", "d"),
    "w_gate": ("d", "f"), "w_up": ("d", "f"), "w_down": ("f", "d"),
}


def _dims(cfg: LlamaConfig):
    return {"d": cfg.hidden_size, "f": cfg.intermediate_size,
            "qh": cfg.num_heads * cfg.head_dim_, "kh": cfg.kv_heads * cfg.head_dim_}


@torch.library.custom_op("handsonvlm_torch::lora_u", mutates_args=())
def lora_u(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The adapter's first stage x @ a, as an op the remat policy can see."""
    return x @ a


def _lora_u_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _lora_u_backward(ctx, du):
    x, a = ctx.saved_tensors
    dx = du @ a.transpose(-1, -2) if ctx.needs_input_grad[0] else None
    da = None
    if ctx.needs_input_grad[1]:
        da = x.reshape(-1, x.shape[-1]).t() @ du.reshape(-1, du.shape[-1])
    return dx, da


lora_u.register_autograd(_lora_u_backward, setup_context=_lora_u_setup)


class LoraAdapter(nn.Module):
    """One target's stacked adapter: a (L, din, r), b (L, r, dout)."""

    def __init__(self, num_layers: int, din: int, r: int, dout: int, dtype, device):
        super().__init__()
        self.a = nn.Parameter(torch.empty((num_layers, din, r), dtype=dtype, device=device))
        self.b = nn.Parameter(torch.empty((num_layers, r, dout), dtype=dtype, device=device))


class LoRA(nn.Module):
    """The adapters of every target (`adapters[name].a` / `.b`) and the
    constant `scale` = alpha / r. A tensor-parallel rank's adapters are
    slices of these (`parallel.tp.shard_lora_tp`: a column target's b
    (L, r, dout/tp), a row target's a (L, din/tp, r)); `layer(i)` gives
    their views alike."""

    def __init__(self, cfg: LlamaConfig, r: int = 128, alpha: float = 256.0,
                 targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32, device=None):
        super().__init__()
        dims = _dims(cfg)
        self.adapters = nn.ModuleDict({
            t: LoraAdapter(cfg.num_layers, dims[_SHAPES[t][0]], r, dims[_SHAPES[t][1]],
                           dtype, device)
            for t in targets})
        self.register_buffer("scale", torch.tensor(float(alpha) / float(r),
                                                   dtype=torch.float32, device=device))

    def layer(self, i: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Layer i's adapters as views, the JAX package's per-layer tree."""
        return {t: {"a": ad.a[i], "b": ad.b[i]} for t, ad in self.adapters.items()}


@torch.no_grad()
def init_lora(generator: torch.Generator, cfg: LlamaConfig, r: int = 128,
              alpha: float = 256.0, targets: Sequence[str] = DEFAULT_TARGETS,
              dtype=torch.float32, device=None) -> LoRA:
    """A ~ N(0, 0.02), B = 0: the adapter starts as a no-op (the JAX
    package's init; the draws come from `generator`, not from JAX's key)."""
    lora = LoRA(cfg, r, alpha, targets, dtype, device)
    for ad in lora.adapters.values():
        ad.a.normal_(0.0, 0.02, generator=generator)
        ad.b.zero_()
    return lora


def _cast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.to(torch.bfloat16) if LORA_COMPUTE_BF16 and x.dtype == torch.bfloat16 else w


def lora_delta(lora_layer: Optional[Dict], name: str, x: torch.Tensor, scale,
               out_dtype=None):
    """Low-rank activation path (x @ A) @ B * (alpha/r); 0.0 if untargeted.

    The delta is computed in the adapter dtype (f32 in training: a bf16 x
    is promoted, as JAX promotes it) and cast back to x's dtype
    (`out_dtype`: to that, e.g. f32 for a tensor-parallel partial). With
    LORA_COMPUTE_BF16 (env HANDSONVLM_LORA_BF16=1) and a bf16 x, the two
    products run in bf16 with the f32 master adapters cast per use. A
    tensor-parallel rank passes its slices (`parallel.tp.shard_lora_tp`):
    a column target's b holds its output columns, a row target's a its
    input rows (x is then its slice, and the delta a partial sum)."""
    if lora_layer is None or name not in lora_layer:
        return 0.0
    a, b = _cast(lora_layer[name]["a"], x), _cast(lora_layer[name]["b"], x)
    u = lora_u(x.to(a.dtype), a)
    return ((u @ b) * scale).to(out_dtype or x.dtype)


def lora_delta_multi(lora_layer: Optional[Dict], names: Sequence[str], x: torch.Tensor,
                     scale):
    """Deltas for several targets sharing the input x: 0.0 (nothing
    targeted), one concatenated delta (..., sum(dout)) or a tuple of
    per-target deltas. HANDSONVLM_LORA_GROUPED, read at each call as the
    JAX package reads it at trace time: "0" (default) per-target products,
    "1" fully grouped, "first" only the first-stage products grouped."""
    if lora_layer is None or not any(n in lora_layer for n in names):
        return 0.0
    mode = os.environ.get("HANDSONVLM_LORA_GROUPED", "0")
    if mode not in ("1", "first") or any(n not in lora_layer for n in names):
        return tuple(lora_delta(lora_layer, n, x, scale) for n in names)
    return _lora_delta_grouped(lora_layer, names, x, scale, first_only=mode == "first")


def _lora_delta_grouped(lora_layer: Dict, names: Sequence[str], x: torch.Tensor, scale,
                        first_only: bool = False):
    """One x @ [A_1|...|A_n] product for the targets sharing x, then (equal
    output widths, not `first_only`) one batched second product and a
    single concatenated delta, else a tuple of per-target deltas. The
    reductions are the split path's, per target."""
    ads = [lora_layer[n] for n in names]
    r = ads[0]["a"].shape[-1]
    douts = [ad["b"].shape[-1] for ad in ads]
    a_cat = _cast(torch.cat([ad["a"] for ad in ads], dim=-1), x)
    u = lora_u(x.to(a_cat.dtype), a_cat)
    if not first_only and len(set(douts)) == 1:
        b_stk = _cast(torch.stack([ad["b"] for ad in ads]), x)  # (n, r, dout)
        un = u.reshape(*u.shape[:-1], len(ads), r)
        d = torch.einsum("...nr,nro->...no", un, b_stk)
        d = d.reshape(*u.shape[:-1], len(ads) * douts[0])
        return (d * scale).to(x.dtype)
    return tuple(((u[..., i * r:(i + 1) * r] @ _cast(ad["b"], x)) * scale).to(x.dtype)
                 for i, ad in enumerate(ads))


@torch.no_grad()
def merge_lora(llama, lora: LoRA) -> None:
    """Fold the adapters into a dense decoder's weights in place (export,
    fast inference): W += A @ B * scale, in each weight's dtype."""
    from handsonvlm_torch.models.llama import _PROJ

    if llama.int4 is not None or llama.proj is not None:
        raise ValueError("merge_lora folds adapters into a dense decoder only")
    for t, ad in lora.adapters.items():
        sub, lin = _PROJ[t]
        delta = torch.einsum("lir,lro->lio", ad.a, ad.b) * lora.scale
        for i, lp in enumerate(llama.layers):
            w = getattr(getattr(lp, sub), lin).weight  # (dout, din)
            w.add_(delta[i].t().to(w.dtype))
