"""Process-group setup, eval-metric gathering and launching ranks.

Port of `handsonvlm_tpu/parallel/distributed.py`: the JAX package calls
`jax.distributed.initialize()` and gathers eval metrics with
`process_allgather`; here `initialize` starts the `torch.distributed`
default group (NCCL on the card, gloo on the CPU) from torchrun's
environment or from explicit arguments, and `gather_metrics` all-gathers;
`gather_records` collects per-clip evaluation records the ranks hold in
unequal numbers.

An NCCL initialisation that fails raises: there is no gloo fallback on a
card. `spawn` starts N ranks of a function on this machine (the tests,
`parallel/dryrun.py` and chip_smoke's phase 19 use it); a rank that fails
fails the launch.
"""

from __future__ import annotations

import os
import pickle
import socket
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


def device_type(device: Optional[str] = None) -> str:
    """"cuda" or "cpu": `device`'s type, by default cuda when there is a card."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def backend_for(device: Optional[str] = None) -> str:
    return "nccl" if device_type(device) == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Start the default process group. A no-op when it is already up, or
    for a single process (no arguments and no torchrun environment). The
    address is `tcp://host:port` (or `host:port`); without arguments the
    group comes from torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
    `MASTER_PORT`. On the card each rank takes `cuda:LOCAL_RANK` (the rank
    without torchrun's `LOCAL_RANK`) before the group starts."""
    if dist.is_initialized():
        return
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and num_processes is None and env_world <= 1:
        return
    world = int(num_processes if num_processes is not None else env_world)
    rank = int(process_id if process_id is not None else os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    kind = device_type(device)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') on a machine without a card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend_for(kind), init_method=coordinator_address,
                            world_size=world, rank=rank)


def ensure_process_group(device: Optional[str] = None) -> None:
    """`initialize()`, and when that leaves no group (one process), a
    one-rank group of its own, so a mesh can be built in any process."""
    initialize(device=device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1)


def gather_metrics(tree: Any) -> Any:
    """All-gather host-local metric arrays across the ranks, concatenated
    on axis 0 (the eval gather); one process: the leaves as numpy. Leaves
    are dict values, list / tuple items or arrays."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _map(np.asarray, tree)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"

    def gather(x):
        x = np.asarray(x)
        t = torch.as_tensor(np.ascontiguousarray(x), device=device)
        if t.dim() == 0:
            t = t[None]
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.cat(parts).cpu().numpy()

    return _map(gather, tree)


def gather_records(records: dict) -> dict:
    """Merge the ranks' per-clip records ({clip index: picklable record},
    in unequal numbers a rank, so pickled rather than `gather_metrics`'
    equal shapes) into one dict in clip order, on every rank. The ranks
    hold disjoint clips. One process: `records` in clip order."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(sorted(records.items()))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, records)
    merged: dict = {}
    for part in parts:
        if merged.keys() & part.keys():
            raise ValueError(f"clips {sorted(merged.keys() & part.keys())} held by two ranks")
        merged.update(part)
    return dict(sorted(merged.items()))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (a new tensor, no gradient);
    `t` itself without a process group."""
    t = t.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks; dx = the sum of dy (every
    rank's y depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """`all_reduce_sum`, differentiable."""
    return _AllReduceSum.apply(t, group) if dist.is_initialized() else t


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, address, device, queue, args):
    try:
        initialize(address, world, rank, device=device)
        out = fn(rank, world, *args)
        # by value: tensors sent through the queue as shared memory would
        # vanish with this process
        queue.put((rank, pickle.dumps(out), None))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device: str = "cpu", timeout: float = 900.0):
    """Run `fn(rank, world, *args)` in `nprocs` fresh processes that form
    one process group (NCCL on "cuda", gloo on "cpu", each rank on its own
    card) and return the ranks' results in rank order. `fn` must be a
    module-level function. A rank that raises fails the call with its
    traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    address = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, nprocs, address, device, queue, args), daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(nprocs):
            rank, out, err = _get(queue, procs, timeout)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=5 if errors else timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(results) != nprocs:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"spawned ranks failed (exit codes {codes})\n" + "\n".join(errors))
    return [results[r] for r in range(nprocs)]


def _get(queue, procs, timeout: float):
    """The next (rank, result, error) from the ranks; raises if a rank dies
    without reporting or the wait passes `timeout` seconds."""
    import time

    deadline = time.monotonic() + timeout
    while queue.empty():
        dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if dead and queue.empty():
            time.sleep(0.5)
            if queue.empty():
                raise RuntimeError(f"a spawned rank died without a result (exit codes "
                                   f"{[p.exitcode for p in procs]})")
        if time.monotonic() > deadline:
            raise RuntimeError(f"spawned ranks did not finish in {timeout} s")
        time.sleep(0.01)
    return queue.get()
