"""Process groups, the ('data', 'model') mesh, and the collectives of the
distribution layer (port of ``vrt.dist.mesh``).

The 'data' axis carries ray data parallelism, the 'model' axis volume slab
sharding (``vrt_torch.dist.brick``).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; each rank is one process.

The backend is the caller's choice: gloo on the CPU and for ranks that
share one card, NCCL only where each rank has a card of its own.  gloo
moves no CUDA tensor through ``send`` and ``recv``, so on gloo the
neighbour exchange stages a CUDA tensor through a pinned host buffer; that
choice is made from the backend and the tensor's device, never by catching
an error, and it is counted (``STATS["staged"]``).

``STATS`` counts each collective's calls and the host seconds spent in
them (with a CUDA tensor on gloo that includes the wait for the card to
finish the work that produced the input).  A collective that a backward
runs counts as its kind.

Gradients (the transposes ``vrt`` gets from JAX's autodiff under
``shard_map``): ``all_gather`` and ``all_reduce_sum`` record an autograd
node where their input requires a gradient and a graph is recorded.  The
gather's backward is the reduce-scatter: the sum over the ranks of the
cotangent (an all-reduce: gloo has no reduce-scatter), then this rank's
rows.  The sum's backward is the all-reduce of the cotangent: its output
feeds rank-local work, whose cotangents differ from rank to rank.
``loss_sum`` is the sum of a loss over the ranks whose cotangent every rank
holds already (``jax.lax.psum`` of the loss inside the differentiated
function): its backward hands each rank the cotangent unchanged.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

STATS = {"all_gather": 0, "all_reduce": 0, "send_recv": 0, "staged": 0,
         "seconds": 0.0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0.0 if k == "seconds" else 0


def init_distributed(backend: str, init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> str:
    """Join the default process group (``torch.distributed``), or keep the
    one already joined.  Returns the group's backend."""
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return dist.get_backend()


def make_render_mesh(n_data: int, n_model: int = 1,
                     device_type: str = "cuda"):
    """An (n_data, n_model) ``DeviceMesh`` with axes ('data', 'model') over
    every rank of the default group, in rank order: the model axis joins
    adjacent ranks.  ``device_type`` is "cuda" (the default) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    need = n_data * n_model
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} ranks, "
                         f"have {have}")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def local_mesh_shape(n_model: int = 1) -> tuple[int, int]:
    """(n_data, n_model) over every rank of the default group."""
    n = dist.get_world_size()
    if n % n_model:
        raise ValueError(f"{n} ranks do not split into {n_model} model "
                         f"shards")
    return n // n_model, n_model


def axis_group(mesh, axis):
    """The process group of ``axis`` (a name, or a tuple of names for the
    whole mesh), this rank's index on it and its size."""
    if isinstance(axis, tuple):
        if tuple(axis) != tuple(mesh.mesh_dim_names):
            raise ValueError(f"axes {axis} are not the mesh's "
                             f"{mesh.mesh_dim_names}")
        coord = mesh.get_coordinate()
        index = 0
        for name, c in zip(mesh.mesh_dim_names, coord):
            index = index * mesh.size(mesh.mesh_dim_names.index(name)) + c
        return dist.group.WORLD, index, mesh.size()
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(dim)



def _needs_graph(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_gather(x, group):
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    STATS["all_gather"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce(x, group):
    t0 = time.perf_counter()
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    STATS["all_reduce"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        total = _all_reduce(g, ctx.group)
        return total[i * ctx.rows:(i + 1) * ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _LossSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] concatenated in group-rank order:
    [S*n, ...] (``jax.lax.all_gather(..., tiled=True)``); differentiable,
    its backward the reduce-scatter of the cotangent."""
    if _needs_graph(x):
        return _AllGather.apply(x, group)
    return _all_gather(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (``jax.lax.psum``), in a new tensor;
    differentiable, its backward the all-reduce of the cotangent."""
    if _needs_graph(x):
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x, group)


def loss_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's loss term ``x``: the global
    loss on every rank, whose backward passes each rank's cotangent through
    unchanged (a differentiated ``psum`` of the loss, as ``vrt``'s fit
    steps take it)."""
    if _needs_graph(x):
        return _LossSum.apply(x, group)
    return _all_reduce(x, group)


def neighbour_exchange(to_right: torch.Tensor, to_left: torch.Tensor,
                       group):
    """The neighbour pair of ``jax.lax.ppermute``: rank i sends
    ``to_right`` to rank i+1 and ``to_left`` to rank i-1 of ``group``, and
    returns (what rank i-1 sent right, what rank i+1 sent left), None at the
    group's ends.  Both tensors have one shape and dtype."""
    t0 = time.perf_counter()
    me = dist.get_rank(group)
    size = dist.get_world_size(group)
    # gloo's send and recv take host memory only
    staged = to_right.is_cuda and dist.get_backend(group) == "gloo"
    dev = to_right.device

    def wire(x):
        x = x.contiguous()
        if not staged:
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def buffer():
        return torch.empty(to_right.shape, dtype=to_right.dtype,
                           device="cpu" if staged else dev,
                           pin_memory=staged)

    sends, recvs = [], {}
    if me + 1 < size:
        recvs["right"] = buffer()
        sends.append((wire(to_right), me + 1))
    if me > 0:
        recvs["left"] = buffer()
        sends.append((wire(to_left), me - 1))
    reqs = [dist.isend(x, dst=dist.get_global_rank(group, peer), group=group)
            for x, peer in sends]
    if "left" in recvs:
        reqs.append(dist.irecv(recvs["left"],
                               src=dist.get_global_rank(group, me - 1),
                               group=group))
    if "right" in recvs:
        reqs.append(dist.irecv(recvs["right"],
                               src=dist.get_global_rank(group, me + 1),
                               group=group))
    for r in reqs:
        r.wait()
    if staged:
        recvs = {k: v.to(dev) for k, v in recvs.items()}
        STATS["staged"] += 1
    STATS["send_recv"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return recvs.get("left"), recvs.get("right")


def spawn_world(fn, world_size: int, args=(), backend: str = "gloo",
                timeout: float = 600.0):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (start method ``spawn``) that first join one default process
    group of ``backend`` over a ``FileStore`` in a temporary directory (no
    TCP port to pick).  Returns what each rank returned, in rank order
    (pickled through a file: return host objects).  Raises with the rank's
    traceback if one fails, and ``TimeoutError`` (after ending them) if the
    ranks are not done within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        ctx = mp.start_processes(_world_entry,
                                 args=(fn, world_size, backend, td, args),
                                 nprocs=world_size, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks not done in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10.0)
        out = []
        for r in range(world_size):
            with open(os.path.join(td, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _world_entry(rank, fn, world_size, backend, td, args):
    init_distributed(backend, "file://" + os.path.join(td, "store"),
                     world_size, rank)
    try:
        result = fn(rank, world_size, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(td, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
