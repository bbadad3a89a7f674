"""Parameter partitioning rules and FSDP2 sharding of the train path.

Port of `handsonvlm_tpu/parallel/partition.py`. The rule table maps a
parameter's name to a spec, one mesh axis name (or None) per dimension;
the first matching rule wins and an unmatched parameter is replicated. The
JAX rules are written for its (L, din, dout) leaves; here they are
translated to the port's names and HF layouts ((dout, din) weights, one
module per layer), so `'data'` lands on the same logical dimension.
`_clamp_spec` drops an axis from a dimension it does not divide, and an
axis the mesh does not have, as the JAX package's does (the 32101-row
embedding and head stay whole on 2 or 4 ranks).

`shard_model(model, mesh)` applies FSDP2 (`fully_shard`) over the mesh's
`data` axis: one unit per decoder layer, one per CLIP layer, and the root.
A parameter whose clamped spec has `'data'` is sharded on that dimension;
the rest (norms, biases, scales, position and class embeddings, and the
dimensions no rank count divides) stay whole on every rank, outside FSDP,
and `sync_replicated_grads` averages their gradients over the ranks as
FSDP2 does its own. On a ('data', 'seq') mesh the units are hybrid:
sharded over `data`, replicated over `seq`, gradients reduced over both.
FSDP2 shards parameters, not buffers: the frozen int4 / int8 QLoRA bases
are buffers and stay whole on each rank. The LoRA adapters stay whole too,
beside the table's rule for them: they are f32 master weights over a bf16
base, and FSDP2 takes one dtype a unit, while the adapters are read inside
every decoder layer's unit (r = 128 at 7B: 1.2 GiB of f32 a rank, with
their Adam moments three times that).

On a ('data', 'model') mesh the model is first cut over `model`
(`tp.shard_for_training`, Megatron's cuts) and FSDP2 then shards each
rank's slices over `data` alone: the rules' 'data' dimension of a slice,
the 'model' entries left to the cut. The parameters a model group holds
whole get the same gradient on each of its ranks, so
`sync_replicated_grads` averages them over the data axis only; the LoRA
factors each rank holds a partial gradient of (`tp.shard_lora_tp`) are
first summed over the model axis.

`full_state_dict` / `load_full_state_dict` move between the sharded model
and the whole state dict a one-rank run saves (FSDP shards gathered over
`data`, model slices over `model`, one tensor at a time), so a checkpoint
written by N ranks resumes in one and the other way round, whatever the
mesh.

`eval_model` gives a rank the model it decodes with during training (the
train CLI's `--eval-every`): a plain copy of its model slices, whole over
`data`, beside the sharded one, which it leaves untouched. FSDP2 would
all-gather each unit over `data` at every decode step, in lockstep across
data ranks that decode clips of other lengths, and its gathers under the
sampler's `inference_mode` would leave inference tensors behind for the
next training step; the copy takes the gathers once, outside
`inference_mode`, and is dropped after the evaluation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from handsonvlm_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    data_group,
    mesh_shape,
    model_group,
)
from handsonvlm_torch.parallel.tp import gather_dim, model_cuts, slice_dim

Spec = Tuple[Optional[str], ...]

# decoder: HF (dout, din) weights; JAX's (L, din, dout) 'data' on din is dim 1 here
LLAMA_RULES: List[Tuple[str, Spec]] = [
    (r"llama\.embed_tokens\.weight$", ("data", "model")),  # (V, D), as JAX's
    (r"self_attn\.(q|k|v)_proj\.weight$", ("model", "data")),
    (r"self_attn\.o_proj\.weight$", ("data", "model")),
    (r"mlp\.(gate|up)_proj\.weight$", ("model", "data")),
    (r"mlp\.down_proj\.weight$", ("data", "model")),
    (r"llama\.layers\.\d+\.(input_layernorm|post_attention_layernorm)\.weight$", ()),
    (r"llama\.norm\.weight$", ()),
    (r"llama\.lm_head\.weight$", ("model", "data")),  # JAX (D, V) P('data', 'model')
]

VISION_RULES: List[Tuple[str, Spec]] = [
    # conv (cout, cin, kh, kw); JAX's (kh, kw, cin, cout) shards cout
    (r"vision\..*patch_embedding\.weight$", ("data", None, None, None)),
    (r"vision\..*(q_proj|k_proj|v_proj|fc1)\.weight$", ("model", "data")),
    (r"vision\..*(out_proj|fc2)\.weight$", ("data", "model")),
    (r"vision\..*(position_embedding\.weight|class_embedding)$", ()),
    (r"vision\..*bias$", ()),
    (r"vision\..*(layernorm|layrnorm|layer_norm\d)\.weight$", ()),
]

LORA_RULES: List[Tuple[str, Spec]] = [
    # adapters stacked (L, din, r) / (L, r, dout): FSDP-shard the big dim
    (r"lora\.adapters\..*\.a$", (None, "data", None)),
    (r"lora\.adapters\..*\.b$", (None, None, "data")),
]

HEAD_RULES: List[Tuple[str, Spec]] = [
    # mm projector: JAX kernel (1024, D) P('data', 'model') is (D, 1024) here
    (r"projector\.weight$", ("model", "data")),
    (r"projector\.bias$", ("model",)),
    # CVAE head: small MLPs, FSDP only (JAX kernel (din, dout) on din)
    (r"traj\..*weight$", (None, "data")),
    (r"traj\..*bias$", ()),
]

QUANT_RULES: List[Tuple[str, Spec]] = [
    # int4 stacked buffers: column-parallel over `model` (parallel/tp.py)
    (r"\.w4$", (None, None, None, "model")),
    (r"\.gscale$", (None, None, "model")),
    (r"\.w4t$", (None, "model", None, None, None)),
    (r"\.gst$", (None, "model", None, None)),
    # int8 stacked (L, din, dout): the dense rules' layout
    (r"proj\.(wq|wk|wv|w_gate|w_up)\.w8$", (None, "data", "model")),
    (r"proj\.(wo|w_down)\.w8$", (None, "model", "data")),
    (r"lm_head\.w8$", ("model", "data")),  # (V, D)
    (r"(wq|wk|wv|wo|w_gate|w_up|w_down|lm_head)\.scale$", ()),
]

DEFAULT_RULES: List[Tuple[str, Spec]] = (
    QUANT_RULES + LLAMA_RULES + VISION_RULES + LORA_RULES + HEAD_RULES
)


def spec_for_path(path: str, rules=None) -> Spec:
    rules = DEFAULT_RULES if rules is None else rules
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def _clamp_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop an axis from a dimension it does not divide, and every axis the
    mesh lacks (the rules name 'model', a --seq-parallel mesh is ('data',
    'seq'): those dimensions stay whole)."""
    sizes = mesh_shape(mesh) if not isinstance(mesh, dict) else mesh
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None or axis not in sizes:
            out.append(None)
            continue
        out.append(axis if dim % sizes[axis] == 0 else None)
    return tuple(out)


def data_dim(name: str, shape, mesh, rules=None) -> Optional[int]:
    """The dimension FSDP shards over `data` (None: replicated)."""
    spec = _clamp_spec(spec_for_path(name, rules), shape, mesh)
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


def _fsdp_mesh(mesh):
    """The mesh FSDP2 takes: the `data` axis, or on ('data', 'seq') a
    (seq, data) mesh, replicated over seq and sharded over data."""
    if SEQ_AXIS not in mesh.mesh_dim_names:
        return mesh[DATA_AXIS]
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh.device_type, mesh.mesh.t().contiguous(),
                      mesh_dim_names=(SEQ_AXIS, DATA_AXIS))


def shard_model(model: nn.Module, mesh, rules=None):
    """Apply FSDP2 over `mesh`'s data axis following the rule table: one
    unit per decoder layer and per CLIP layer, then the root. Parameters
    the table keeps whole are left out of FSDP (`model.replicated_params`,
    whose gradients `sync_replicated_grads` averages). On a mesh with a
    model axis the model must already be cut for this rank
    (`tp.shard_for_training`): FSDP2 shards its slices. Returns the model."""
    from torch.distributed.fsdp import fully_shard

    fmesh = _fsdp_mesh(mesh)
    names = {p: n for n, p in model.named_parameters()}
    dims = {p: data_dim(n, p.shape, mesh, rules) for p, n in names.items()}
    if getattr(model, "lora", None) is not None:
        dims.update({p: None for p in model.lora.parameters()})
    replicated = [p for p, d in dims.items() if d is None]

    def place(p):
        return Shard(dims[p]) if dims.get(p) is not None else None

    ignored = set(replicated)
    units = list(model.llama.layers)
    if getattr(model, "vision", None) is not None:
        units += list(model.vision.encoder.layers)
    for unit in units:
        fully_shard(unit, mesh=fmesh, shard_placement_fn=place,
                    ignored_params={p for p in unit.parameters() if p in ignored})
    fully_shard(model, mesh=fmesh, shard_placement_fn=place, ignored_params=ignored)
    model.replicated_params = replicated
    lora = getattr(model, "lora", None)
    partial = set(getattr(lora, "tp_partial", ()))
    model.partial_params = ([] if lora is None else
                            [p for n, p in lora.named_parameters() if n in partial])
    model.fsdp_mesh = mesh
    return model


def _all_reduce_into(grads, group, divide: int = 1) -> None:
    """Sum the gradients `grads` over `group` in f32 (one collective),
    divided by `divide`, in place."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    if divide > 1:
        flat /= divide
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


def sync_replicated_grads(model: nn.Module) -> None:
    """Average the gradients of the parameters FSDP leaves whole over the
    ranks that hold other rows (every rank, or on a ('data', 'model') mesh
    the data axis), as FSDP2 averages those of its shards; on a model axis
    the partial gradients of the LoRA factors (`model.partial_params`) are
    summed over it first."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    mesh = getattr(model, "fsdp_mesh", None)
    tp = model_group(mesh)
    partial = [p.grad for p in getattr(model, "partial_params", ()) if p.grad is not None]
    if tp is not None and partial:
        _all_reduce_into(partial, tp.group)
    grads = [p.grad for p in getattr(model, "replicated_params", ()) if p.grad is not None]
    group = data_group(mesh)
    n = dist.get_world_size(group)
    if grads and n > 1:
        _all_reduce_into(grads, group, n)


def is_sharded(model: nn.Module) -> bool:
    return hasattr(model, "fsdp_mesh")


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor shard (a collective: every rank
    calls it), a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole state dict on the CPU, as a one-rank model's: every rank
    must call it (the FSDP shards and the model slices, `tp.model_cuts`,
    are gathered one tensor at a time); ranks other than the first get an
    empty dict."""
    main = not dist.is_initialized() or dist.get_rank() == 0
    cuts = model_cuts(module)
    out = {}
    for name, t in module.state_dict().items():
        t = full_tensor(t)
        if name in cuts:
            dim, tp = cuts[name]
            t = gather_dim(t.detach(), tp, dim)
        if main:
            out[name] = t.detach().cpu()
    return out


@torch.no_grad()
def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`full` cut as `like` is: its shard of a DTensor, else whole (on
    like's device, in like's dtype)."""
    full = full.to(like.device, like.dtype)
    if not isinstance(like, DTensor):
        return full
    return distribute_tensor(full, like.device_mesh, like.placements).to_local()


@torch.no_grad()
def load_full_state_dict(module: nn.Module, state: Dict[str, Any]) -> None:
    """Load a whole state dict (every rank reads it) into a model, sharded
    or not: each rank keeps its part (its model slice, `tp.model_cuts`,
    then its FSDP shard of that). Keys must match exactly."""
    own = module.state_dict()
    missing, extra = set(own) - set(state), set(state) - set(own)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    cuts = model_cuts(module)
    for name, t in own.items():
        full, shape = state[name], list(t.shape)
        if name in cuts:
            shape[cuts[name][0]] *= cuts[name][1].size
        if tuple(full.shape) != tuple(shape):
            raise ValueError(f"{name}: saved {tuple(full.shape)}, model {tuple(shape)}")
        if name in cuts:
            full = slice_dim(full, cuts[name][1], cuts[name][0])
        part = local_part(full, t)
        (t.to_local() if isinstance(t, DTensor) else t).copy_(part)


@torch.no_grad()
def eval_model(model: nn.Module, cfg) -> nn.Module:
    """The model a rank decodes with during training: a plain `HandsOnVLM`
    (no FSDP unit, so a decode step issues no collective over the data
    axis) holding this rank's model slices, each DTensor made whole over
    `data` (a collective: every rank calls it) and every other tensor (the
    replicated parameters, the QLoRA bases, the LoRA adapters) shared with
    the training model, whose parameters, buffers and FSDP state are left
    as they are. The Megatron cut is kept (`tp_layout`, the adapters'
    `tp_for`): run it with the model group's `TPGroup`. A model that is not
    sharded is returned as it is. The copy costs the whole-over-`data`
    bytes of the sharded parameters."""
    if not is_sharded(model):
        return model
    from handsonvlm_torch.models.handsonvlm import HandsOnVLM
    from handsonvlm_torch.models.lora import LoRA

    state = {name: full_tensor(t).detach() for name, t in model.state_dict().items()}
    with torch.device("meta"):
        plain = HandsOnVLM(cfg, quantize=model.llama.quantize)
        if model.lora is not None:
            plain.lora = LoRA(cfg.llama, r=1, targets=tuple(model.lora.adapters))
    for name, t in state.items():
        owner, _, leaf = name.rpartition(".")
        mod = plain.get_submodule(owner)
        kept = isinstance(getattr(mod, leaf), nn.Parameter)
        setattr(mod, leaf, nn.Parameter(t, requires_grad=False) if kept else t)
    left = [n for n, t in list(plain.named_parameters()) + list(plain.named_buffers())
            if t.is_meta]
    if left:
        raise ValueError(f"eval_model: {left[:3]} not in the training model's state dict")
    plain.llama.tp_layout = model.llama.tp_layout
    if model.lora is not None:
        plain.lora.tp_for = getattr(model.lora, "tp_for", None)
    return plain.eval()


def bytes_per_rank(model: nn.Module) -> Dict[str, int]:
    """This rank's bytes of parameters (its shards of its model slices,
    and the whole replicated ones) and of buffers (its slices of the
    QLoRA bases, whole where they are not cut)."""
    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    params = sum(local(p).numel() * local(p).element_size() for p in model.parameters())
    bufs = sum(b.numel() * b.element_size() for b in model.buffers())
    return {"params": params, "buffers": bufs}
