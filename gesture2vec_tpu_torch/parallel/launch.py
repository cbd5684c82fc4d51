"""Starting the ranks of a mesh on one host.

`run(fn, args, kwargs, world_size, device)` runs fn(*args, **kwargs) on
world_size local ranks started with torch.multiprocessing's spawn and
returns rank 0's result. The rendezvous is a file in a fresh temporary
directory (`init_method="file://..."`), so concurrent runs on one host
never meet on a port. The CPU runs gloo; cards run NCCL, one card a
rank, unless `backend="gloo"` asks for gloo ranks (which may share a
card). Every rank runs `torch.set_num_threads(1)`. Where a process group
of that size already runs (torchrun: `torchrun_group` joins it), fn runs
in place.

`spmd(fn)` wraps a trainer taking (config, ...): called with a
config.mesh_shape in a plain process, it starts the mesh's ranks, runs
the trainer in each and returns rank 0's (model, history), so
`train_dae(cfg_with_mesh, frames, val)` keeps the one-call API of the
JAX package, whose trainers shard over the host's devices in place.
fn and its arguments are pickled to the ranks: fn is a module-level
function (pickled by its module and name).
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import shutil
import tempfile
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist


@contextlib.contextmanager
def torchrun_group(device) -> Iterator[bool]:
    """Inside: the process group that torchrun describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; env://),
    joined over NCCL on the rank's card (LOCAL_RANK) or gloo on the CPU,
    and left on the way out; yields whether it joined. Outside torchrun,
    or where a process group already runs, nothing."""
    env = os.environ
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                      "MASTER_PORT"))
    if not torchrun or (dist.is_available() and dist.is_initialized()):
        yield False
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    try:
        yield True
    finally:
        dist.destroy_process_group()


def in_ranks(world_size: int) -> bool:
    """A process group of world_size ranks is running here."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == world_size)


def _entry(rank: int, fn: Callable, args: Sequence[Any],
           kwargs: Dict[str, Any], world_size: int, backend: str,
           rendezvous: str, result: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=world_size, rank=rank)
    try:
        out = fn(*args, **kwargs)
        if rank == 0:
            torch.save(out, result)
    except BaseException as e:
        try:             # the caller raises the rank's own exception
            torch.save(e, f"{result}.error{rank}")
        except Exception:
            pass
        raise
    finally:
        dist.destroy_process_group()


def run(fn: Callable, args: Sequence[Any] = (),
        kwargs: Optional[Dict[str, Any]] = None, world_size: int = 1,
        device: Any = None, backend: Optional[str] = None) -> Any:
    """fn(*args, **kwargs) on world_size ranks; rank 0's result (loaded
    onto device where it holds tensors). A rank's exception is raised
    here as it was raised there (the lowest rank's)."""
    kwargs = dict(kwargs or {})
    if in_ranks(world_size):
        return fn(*args, **kwargs)
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tmp = tempfile.mkdtemp(prefix="g2v_ranks_")
    try:
        result = os.path.join(tmp, "result.pt")
        try:
            torch.multiprocessing.spawn(
                _entry, args=(fn, tuple(args), kwargs, world_size, backend,
                              os.path.join(tmp, "rendezvous"), result),
                nprocs=world_size, join=True)
        except Exception as spawn_error:
            for rank in range(world_size):
                path = f"{result}.error{rank}"
                if os.path.exists(path):
                    raise torch.load(path, weights_only=False) \
                        from spawn_error
            raise
        return torch.load(result, map_location=dev, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def call_all(calls: Sequence[Tuple[Callable, Sequence[Any],
                                    Dict[str, Any]]]) -> List[Any]:
    """[fn(*args, **kwargs) for each call], in order: several entry points
    in one set of ranks (`run(call_all, (calls,), ...)`), each starting
    none of its own."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def spmd(trainer: Callable) -> Callable:
    """A trainer(config, ...) that starts its own ranks for a
    config.mesh_shape (see the module note). The mesh is checked against
    the devices, and config.batch_size (the global batch) against dp,
    before any rank starts."""

    @functools.wraps(trainer)
    def wrapper(config, *args, **kwargs):
        shape = config.mesh_shape
        if not shape:
            return trainer(config, *args, **kwargs)
        world = math.prod(int(v) for v in shape.values())
        if in_ranks(world):
            return trainer(config, *args, **kwargs)
        from gesture2vec_tpu_torch.parallel.mesh import make_mesh
        # too few cards, or a global batch dp does not divide: raise here
        make_mesh(shape, kwargs.get("device")).check_batch(
            config.batch_size)
        return run(wrapper, (config,) + tuple(args), kwargs, world,
                   kwargs.get("device"))

    return wrapper
