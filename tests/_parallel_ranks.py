"""What each gloo rank of the port's parallel tests runs.

`handsonvlm_torch.parallel.distributed.spawn` starts the ranks in fresh
processes that import this module (no JAX here, so a rank starts fast);
the test files build the inputs from numpy seeds, hand them in, and hold
what rank 0 returns against the JAX package on its 8-device CPU mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _groups(rank: int, world: int):
    """{tp size: this rank's TPGroup}: every rank at tp = world, and at
    tp = 2 the pairs (0, 1), (2, 3), ..."""
    from handsonvlm_torch.parallel.tp import TPGroup

    out = {world: TPGroup.world()}
    if world > 2:
        pairs = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
        out[2] = TPGroup(rank % 2, 2, pairs[rank // 2])
    return out


def _heads(x, tp, dim):
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n).contiguous()


def tp_rank(rank: int, world: int, cases: dict, gen: dict) -> dict:
    """Every tensor-parallel op at tp = 2 and tp = world on this rank's
    shards: the int4 matmuls (tiled and flat weights, decode and prefill
    rows) and the head-sharded decode attention (a bf16 cache and the int8
    one, T = 1 and a window); then the tiny model `gen["state"]` cut for
    this rank, a greedy generate_host over its own cache and over the int8
    one. Returns rank 0's {key: output}."""
    from handsonvlm_torch.convert.from_hf import load_state_dict_into, quantize_mode
    from handsonvlm_torch.infer.builder import build_model
    from handsonvlm_torch.infer.sampler import generate_host
    from handsonvlm_torch.parallel import tp as tp_mod

    torch.set_num_threads(1)
    out = {}
    for tp_n, tp in sorted(_groups(rank, world).items()):
        for name, (w, s, xs, layer) in cases["int4"].items():
            part = tp_mod.shard_int4_stacked(_t(w), _t(s), tp.rank, tp.size)
            args, group = (part, tp) if part is not None else ((_t(w), _t(s)), None)
            out[("int4 split", name, tp_n)] = part is not None
            for m, x in xs.items():
                y = tp_mod.int4_matmul_stacked_tp(_t(x), *args, layer, tp=group)
                out[("int4", name, m, tp_n)] = y.numpy()
        for name, c in cases["attn"].items():
            dtype = torch.bfloat16 if c["bf16"] else torch.float32
            q = _t(c["q"]).to(dtype)
            if "ks" in c:
                ck, cv, ks, vs = (_t(c[k]) for k in ("ck", "cv", "ks", "vs"))
                y = tp_mod.decode_attention_stacked_q_tp(
                    q, _heads(ck, tp, 3), _heads(cv, tp, 3), _heads(ks, tp, 2),
                    _heads(vs, tp, 2), c["layer"], c["length"], tp=tp)
            else:
                ck, cv = _t(c["ck"]).to(dtype), _t(c["cv"]).to(dtype)
                y = tp_mod.decode_attention_stacked_tp(
                    q, _heads(ck, tp, 3), _heads(cv, tp, 3), c["layer"], c["length"], tp=tp)
            out[("attn", name, tp_n)] = y.float().numpy()

        cfg, state = gen["cfg"], gen["state"]
        model = build_model(cfg, "cpu", quantize=quantize_mode(state))
        load_state_dict_into(model, {k: _t(v) for k, v in state.items()})
        tp_mod.shard_llama_tp(model.llama, cfg.llama, tp.rank, tp.size)
        for kv in (None, "int8"):
            c0 = tp_mod.COLLECTIVES
            res = generate_host(model, cfg, gen["ids"], gen["images"],
                                torch.Generator().manual_seed(0), max_new_tokens=8,
                                temperature=0.0, kv_quant=kv, tp=tp)
            out[("generate", kv, tp_n)] = (res.sequences.copy(), tp_mod.COLLECTIVES - c0)
        out[("layout", tp_n)] = dataclasses.asdict(model.llama.tp_layout)
    return out if rank == 0 else {}


def train_rank(rank: int, world: int, job: dict) -> dict:
    """The port's parallel training on this rank. `job["kind"]`:
    "ring+seq" (4 ranks: ring attention and its gradients at P = 4 and on
    a 2 x 2 ('data', 'seq') mesh, then the sequence-parallel step on that
    mesh) or "step+cli" (2 ranks: the FSDP2 step, its refusal of a batch
    the ranks do not divide, the train CLI's main() as torchrun starts it,
    the mesh's errors). Returns rank 0's results."""
    from handsonvlm_torch.parallel.distributed import gather_metrics, is_main_process
    from handsonvlm_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    out = {}
    if job["kind"] == "ring+seq":
        out["ring"], out["indivisible"] = {}, {}
        for p in (4, 2):
            ring, msg = _ring(create_mesh(seq=p, device="cpu"), job["ring"], p)
            out["ring"].update(ring)
            out["indivisible"][p] = msg
        out["seq"] = _step(rank, world, job["seq"])
    else:
        out["step"] = _step(rank, world, job["step"])
        odd = dict(job["step"], batch={k: np.concatenate([v, v[:1]])
                                       for k, v in job["step"]["batch"].items()})
        try:
            _step(rank, world, odd)
        except ValueError as e:
            out["odd batch"] = str(e)
        from handsonvlm_torch.train import train

        out["cli step"] = train.main(job["argv"]).step
        errors = []
        for kw in (dict(seq=2, model=2), dict(data=3), dict(model=4)):
            try:
                create_mesh(device="cpu", **kw)
            except ValueError as e:
                errors.append(str(e))
        out["mesh errors"] = errors
        out["main"] = gather_metrics(np.asarray([is_main_process()])).tolist()
    return out if rank == 0 else {}


def _ring(mesh, cases, p):
    """Each case's ring attention over `mesh`'s 'seq' axis of `p` ranks
    (every data rank the whole batch): output and input gradients under
    the case's cotangent, gathered back to whole sequences."""
    from handsonvlm_torch.parallel.ring_attention import ring_attention, shard_sequence

    group = mesh.get_group("seq")
    out = {}
    for name, c in cases.items():
        if (name, p) not in {("causal", 2), ("causal", 4), ("full", 4), ("gqa masked", 2),
                             ("gqa masked", 4)}:
            continue
        q, k, v = (shard_sequence(_t(c[n]), mesh).clone().requires_grad_(True)
                   for n in ("q", "k", "v"))
        mask = None if c["mask"] is None else shard_sequence(_t(c["mask"]), mesh)
        y = ring_attention(q, k, v, mesh=mesh, causal=c["causal"], key_mask=mask)
        (y * shard_sequence(_t(c["dy"]), mesh)).sum().backward()
        whole = []
        for part in (y.detach(), q.grad, k.grad, v.grad):
            parts = [torch.empty_like(part) for _ in range(p)]
            dist.all_gather(parts, part.contiguous(), group=group)
            whole.append(torch.cat(parts, dim=1).numpy())
        out[(name, p)] = whole
    try:
        shard_sequence(torch.zeros((1, 4 * p + 1, 2, 8)), mesh)
    except ValueError as e:
        return out, str(e)
    return out, None


def _step(rank, world, job):
    """`len(job["eps"])` sharded train steps of the model `job["state"]`
    (FSDP2 over the mesh's data axis; ring attention with `job["seq"]` >
    1): the metrics, the whole trained parameters, and every rank's index
    gathered."""
    from handsonvlm_torch.convert.from_hf import load_state_dict_into
    from handsonvlm_torch.infer.builder import build_model
    from handsonvlm_torch.parallel.distributed import gather_metrics
    from handsonvlm_torch.parallel.mesh import create_mesh
    from handsonvlm_torch.parallel.partition import full_state_dict, shard_model
    from handsonvlm_torch.train.step import make_train_step
    from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

    cfg = job["cfg"]
    model = build_model(cfg, "cpu")
    load_state_dict_into(model, {k: _t(v) for k, v in job["state"].items()})
    seq = job.get("seq", 1)
    mesh = create_mesh(seq=seq, device="cpu")
    shard_model(model, mesh)
    opt = make_optimizer(model, learning_rate=job["lr"], freeze_top_keys=job["freeze"])
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="xla", mesh=mesh,
                           seq_mesh=mesh if seq > 1 else None)
    metrics = [step(state, job["batch"], 1, eps=_t(e)) for e in job["eps"]]
    params = full_state_dict(model)
    names = {n for n, _ in model.named_parameters()}
    return {"metrics": metrics,
            "state": {k: v.numpy() for k, v in params.items() if k in names},
            "ranks": gather_metrics(np.asarray([rank]))}


def tp_train_rank(rank: int, world: int, job: dict) -> dict:
    """Tensor parallelism inside training on this rank: for each run of
    `job["runs"]` ((data, model), mode, ...), the model `job["states"][mode]`
    cut for this rank (`parallel.tp.shard_for_training`), FSDP2 over the
    data axis, `len(job["eps"])` steps; then the checkpoint round trips and
    the train CLI under `--model-axis` (`job["ckpt"]`, `job["argv"]`).
    Returns every rank's results: per run the metrics, the whole trained
    parameters (rank 0), this rank's gradients of the parameters its model
    group holds whole and of its slices at the first step (gathered over
    the data axis), the collectives a step."""
    from handsonvlm_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    out = {"runs": {}}
    for shape, mode in job["runs"]:
        mesh = create_mesh(data=shape[0], model=shape[1], device="cpu")
        out["runs"][(shape, mode)] = _tp_steps(job, mesh, mode)
    if job.get("ckpt"):
        out["ckpt"] = _tp_checkpoints(job)
    if job.get("argv"):
        from handsonvlm_torch.train import train

        out["cli step"] = train.main(job["argv"]).step
    return out


def _tp_model(job, mode, mesh):
    """The run's model cut for this rank and sharded, its optimizer and
    train state."""
    from handsonvlm_torch.infer.builder import build_model
    from handsonvlm_torch.models.lora import LoRA
    from handsonvlm_torch.parallel.mesh import model_group
    from handsonvlm_torch.parallel.partition import shard_model
    from handsonvlm_torch.parallel.tp import shard_for_training
    from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

    cfg = job["cfg"]
    model = build_model(cfg, "cpu", quantize=job["quant"][mode])
    if mode != "sft":
        model.lora = LoRA(cfg.llama, r=job["r"], alpha=2.0 * job["r"])
    model.load_state_dict({k: _t(v) for k, v in job["states"][mode].items()})
    tp = model_group(mesh)
    if tp is not None:
        shard_for_training(model, cfg, tp)
    shard_model(model, mesh)
    freeze = ("vision",) if mode == "sft" else ("vision", "llama")
    opt = make_optimizer(model, learning_rate=job["lr"], freeze_top_keys=freeze)
    return model, opt, create_train_state(model, opt)


def _tp_steps(job, mesh, mode):
    from handsonvlm_torch.parallel import tp as tp_mod
    from handsonvlm_torch.parallel.mesh import model_group
    from handsonvlm_torch.parallel.partition import full_state_dict, full_tensor
    from handsonvlm_torch.train.step import make_train_step

    model, opt, state = _tp_model(job, mode, mesh)
    step = make_train_step(job["cfg"], opt, attn_impl="xla", mesh=mesh)
    c0 = tp_mod.COLLECTIVES
    metrics, grads = [], None
    for e in job["eps"]:
        metrics.append(step(state, job["batch"], 1, eps=_t(e)))
        grads = grads or {name: full_tensor(p.grad).detach().numpy().copy()
                          for name, p in model.named_parameters() if p.grad is not None}
    collectives = (tp_mod.COLLECTIVES - c0) // len(job["eps"])
    cuts = tp_mod.model_cuts(model)
    params = full_state_dict(model)
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    tp = model_group(mesh)
    return {"metrics": metrics, "collectives": collectives,
            "state": {k: v.numpy() for k, v in params.items() if k in names},
            "grads": grads, "cuts": {k: d for k, (d, _) in cuts.items()},
            "model rank": 0 if tp is None else tp.rank,
            "data rank": mesh.get_local_rank("data"),
            "layout": dataclasses.asdict(model.llama.tp_layout) if tp is not None else None}


def _tp_checkpoints(job):
    """The checkpoint round trips at (data=2, model=2): the run's trained
    state saved (the one-rank layout), and a one-rank run's checkpoint
    restored and gathered back."""
    from handsonvlm_torch.core.checkpoint import restore_train_state, save_train_state
    from handsonvlm_torch.parallel.mesh import create_mesh
    from handsonvlm_torch.parallel.partition import full_state_dict
    from handsonvlm_torch.train.step import make_train_step

    out = {}
    for mode, saved_dir, written_dir in job["ckpt"]:
        mesh = create_mesh(data=2, model=2, device="cpu")
        model, opt, state = _tp_model(job, mode, mesh)
        step = make_train_step(job["cfg"], opt, attn_impl="xla", mesh=mesh)
        for e in job["eps"]:
            step(state, job["batch"], 1, eps=_t(e))
        save_train_state(written_dir, state, state.step)
        mine = full_state_dict(model), opt.state_dict()
        model, opt, state = _tp_model(job, mode, mesh)
        restore_train_state(saved_dir, state)
        back = full_state_dict(model), opt.state_dict()
        out[mode] = {"mine": mine, "back": back, "step": state.step}
    return out


class _Items:
    """A dataset's items, each read once (the ranks decode the same clips
    in several runs, each with the same per-clip draws)."""

    def __init__(self, dataset):
        self.dataset, self.items = dataset, {}
        self.route_draws = dataset.route_draws

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        if i not in self.items:
            self.items[i] = self.dataset[i]
        return self.items[i]


def _pin_latent(pinned: bool) -> None:
    """With `pinned`, the sampler decodes every waypoint at the CVAE's
    latent 0 instead of a draw (the JAX side of the test pins its own)."""
    from handsonvlm_torch.infer import sampler
    from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint

    def at_zero(model, cfg, hidden, *, z=None, generator=None):
        z = torch.zeros((hidden.shape[0] * 2, cfg.traj.latent_dim), dtype=hidden.dtype,
                        device=hidden.device)
        return decode_hand_waypoint(model, cfg, hidden, z=z)

    sampler.decode_hand_waypoint = at_zero if pinned else decode_hand_waypoint


def eval_rank(rank: int, world: int, job: dict) -> dict:
    """The train CLI's evaluation over several ranks on this rank: for each
    run of `job["runs"]` (shape, mode, pinned), the model
    `job["states"][mode]` cut for this rank on a ('data', 'model') mesh of
    `shape` (or, for shape "seq2", FSDP2 over a ('data', 'seq') mesh of 2 x
    2), sharded by FSDP2, then `eval.evaluator.evaluate_sharded` of the EK
    validation clips under `job["root"]` (greedy, the CVAE latent pinned
    to 0, when `pinned`); then the train CLI for each of `job["cli"]` ({name: argv}),
    its stdout kept. Returns per run the rank's result (scores and the
    per-clip records of every group) and its collectives; per
    CLI run the final step and what the rank printed."""
    import contextlib
    import io
    import os

    from handsonvlm_torch.data.epic_dataset import EpicConversationDataset
    from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name
    from handsonvlm_torch.data.mock_tokenizer import MockTokenizer
    from handsonvlm_torch.eval.evaluator import evaluate_sharded
    from handsonvlm_torch.infer.builder import build_model
    from handsonvlm_torch.models.lora import LoRA
    from handsonvlm_torch.parallel import tp as tp_mod
    from handsonvlm_torch.parallel.mesh import create_mesh, model_group
    from handsonvlm_torch.parallel.partition import shard_model
    from handsonvlm_torch.parallel.tp import shard_for_training

    torch.set_num_threads(1)
    os.environ["HANDSONVLM_DATA_ROOT"] = job["root"]
    os.environ["HANDSONVLM_ASSETS_DIR"] = os.path.join(job["root"], "assets")
    cfg, tokenizer = job["cfg"], MockTokenizer()
    hoi = get_epic_hoi_dataset_by_name("ek100", "validation", load_images=True,
                                       rephrase_rate=0.0, use_percentage=1.0)
    dataset = _Items(EpicConversationDataset(tokenizer, hoi, deterministic=True))
    out = {"runs": {}}
    for shape, mode, pinned in job["runs"]:
        model = build_model(cfg, "cpu", quantize=job["quant"][mode])
        if mode != "sft":
            model.lora = LoRA(cfg.llama, r=job["r"], alpha=2.0 * job["r"])
        model.load_state_dict({k: _t(v) for k, v in job["states"][mode].items()})
        mesh = (create_mesh(seq=2, device="cpu") if shape == "seq2"
                else create_mesh(data=shape[0], model=shape[1], device="cpu"))
        if model_group(mesh) is not None:
            shard_for_training(model, cfg, model_group(mesh))
        shard_model(model, mesh)
        _pin_latent(pinned)
        c0 = tp_mod.COLLECTIVES
        res = evaluate_sharded(model, cfg, tokenizer, dataset, mesh, seed=job["seed"],
                               limit=job["clips"], max_new_tokens=job["new_tokens"],
                               **({"temperature": 0.0} if pinned else {}))
        _pin_latent(False)
        out["runs"][(shape, mode, pinned)] = {"res": res, "collectives": tp_mod.COLLECTIVES - c0}
    out["cli"] = {}
    for name, argv in job.get("cli", {}).items():
        from handsonvlm_torch.train import train

        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            step = train.main(argv).step
        out["cli"][name] = {"step": step, "stdout": text.getvalue()}
    return out
