"""The device mesh and its sharding rules, over torch.distributed ranks.

Port of the JAX package's `parallel/mesh.py`. JAX's mesh is one process
that shards under jit: its semantics are those of the global batch, and
sharding changes placement, not math. The port keeps that with one
process a mesh position (a rank), and collectives where jit's
partitioner would insert them:

  - "dp": every rank takes its rows of each global batch (`Mesh.rows`);
    BatchNorm takes its batch statistics over the dp group and dropout,
    VAE and Gumbel noise are drawn at the global batch's shape from the
    shared-seed generator, each rank keeping its rows
    (`models/layers.batch_shard`); the gradients, the losses and the
    metrics are averaged over dp, so a dp run computes what the single
    run computes (up to the summation order);
  - "tp": the tables whose name holds "codebook" or "embedding_table"
    are row-sharded over the tp ranks (`param_spec`, `shard_params`);
    the quantizers compute their shard's distances (the hard
    assignments through the VQ-argmin kernel on the shard, then the
    smallest distance over the ranks, the lowest global index on ties)
    and the embedding lookups their shard's rows, each all-reduced over
    tp (`TP`); the gradient-clip norm counts every shard once
    (`Mesh.global_norm`), Adam's state stays with its shard, and
    checkpoints gather the full tables (`Mesh.unsharded`);
  - any other axis ("sp", "pp") names ranks for the row-wise sweeps and
    the pipeline (`parallel/pipeline`).

Ranks are row-major over the axes in their order, as JAX reshapes its
devices: rank = sum(coordinate * stride). On the CPU the ranks are gloo
processes (the counterpart of JAX's virtual CPU devices); on cards NCCL
runs one card a rank, and gloo ranks may share a card. Without a
process group (a plain process) a mesh holds its devices, one a
position, and a trainer given a mesh_shape starts its own ranks
(`parallel/launch`). The row-wise sweeps, `generate_batch` and the
server run their rows whole on the process's device there (`Mesh.
map_rows`, logged once a mesh): one host thread issuing every card's
share measured slower than one card doing all of it, whether in turn or
from a thread a card (`scripts/plain_mesh_cards.py`); ranks, each with
its own host thread, split the rows.

Gloo transport. Gloo moves tensors through the host: a collective or a
point-to-point hop (`send`, `recv`: the pipeline's activations) of the
port on a gloo group copies a CUDA tensor to pinned host memory, runs
there and copies back, every time and for every call (`_host`). NCCL
takes the device tensors as they are.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import math
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# parameter-name substrings that shard over "tp" (row-sharded tables)
_TP_TABLE_KEYS = ("codebook", "embedding_table")


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


def all_reduce(t: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce t over the group (a sum unless op says), in place
    (returned)."""
    if _staged(t, group):
        host = _host(t)
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's t (equal shapes), in group-rank order."""
    n = dist.get_world_size(group)
    src = _host(t) if _staged(t, group) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """t from the group's rank src (a global rank), in place."""
    if _staged(t, group):
        host = _host(t)
        dist.broadcast(host, src=src, group=group)
        return t.copy_(host)
    dist.broadcast(t, src=src, group=group)
    return t


def send(t: torch.Tensor, dst: int):
    """Start sending t to the global rank dst; returns the work, to wait
    on before t's next use."""
    return dist.isend(_host(t) if _staged(t, None) else t.contiguous(), dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor of like's shape, type and device from the global rank
    src (blocks until it arrives)."""
    if _staged(like, None):
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    else:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.irecv(buf, src).wait()
    return buf.to(like.device)


class _SumOver(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the gradient too: the
    dp statistics, where every rank's loss reads every rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _SumReplicated(torch.autograd.Function):
    """All-reduce sum of the shards' partial results whose downstream is
    replicated (every tp rank computes the same loss from it): the
    backward passes the gradient through (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterShards(torch.autograd.Function):
    """A replicated value going into the shards' computation: identity
    forward, the shards' gradients summed backward (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """The shards' (N, K/tp) blocks side by side; replicated downstream,
    so the backward keeps this shard's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.cols, ctx.index = x.shape[-1], index
        return torch.cat(all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        c = ctx.cols
        return g[..., ctx.index * c:(ctx.index + 1) * c].contiguous(), \
            None, None


class TP:
    """A row shard of a table over the tp group: this rank's rows are
    [offset, offset + rows) of total. Set on the sharded tensor as
    `_tp` by shard_params; the quantizers and the embedding read it."""

    def __init__(self, group, index: int, size: int, offset: int,
                 total: int):
        self.group, self.index, self.size = group, index, size
        self.offset, self.total = offset, total

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterShards.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumReplicated.apply(x, self.group)

    def gather_columns(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherColumns.apply(x, self.group, self.index)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
        """table[ids] for global ids: this shard's rows, the others
        zero, summed over tp."""
        local = ids - self.offset
        mine = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(mine, local, torch.zeros_like(local))]
        rows = torch.where(mine.unsqueeze(-1), rows, rows.new_zeros(()))
        return self.sum(rows)

    def argmin(self, idx: torch.Tensor, dmin: torch.Tensor
               ) -> torch.Tensor:
        """The global nearest code from each shard's (idx, dmin): the
        smallest distance over the ranks, the lowest rank (so the lowest
        global index, the shards being contiguous) on ties."""
        idx = (idx.long() + self.offset)
        ids = torch.stack(all_gather(idx, self.group))        # (tp, N)
        ds = torch.stack(all_gather(dmin.float(), self.group))
        best = torch.argmin(ds, dim=0)   # first minimum: the lowest rank
        return ids.gather(0, best[None])[0]


class _BatchShard:
    """What `models/layers.batch_shard` needs of the dp axis."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumOver.apply(x, self.group)

    @torch.no_grad()
    def max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.clone(), self.group, dist.ReduceOp.MAX)


class Mesh:
    """Axis names and sizes in order, this rank's coordinates and one
    process group an axis (a plain process: coordinates 0, no groups)."""

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 devices: Sequence[torch.device],
                 groups: Optional[Dict[str, Any]] = None,
                 coords: Optional[Dict[str, int]] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device = device
        self.devices = list(devices)
        self.groups = groups or {}
        self.coords = coords or {a: 0 for a in shape}
        self.distributed = bool(groups)
        self._logged_whole = False

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def is_main(self) -> bool:
        return all(c == 0 for c in self.coords.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    # -- dp ------------------------------------------------------------
    @property
    def dp(self) -> int:
        return self.axis_size("dp") if self.distributed else 1

    def check_batch(self, batch: int) -> int:
        """The rows a dp rank takes of a global batch; ValueError when dp
        does not divide it."""
        if batch % self.axis_size("dp"):
            raise ValueError(f"batch {batch} is not divisible by the dp "
                             f"axis {self.axis_size('dp')} of mesh "
                             f"{self.shape}")
        return batch // self.axis_size("dp")

    def rows(self, batch: Any) -> Any:
        """This dp rank's rows of a global batch (an array or tensor, or
        a tuple or list of them)."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.rows(b) for b in batch)
        if not self.distributed or self.dp == 1:
            return batch
        b = self.check_batch(batch.shape[0])
        i = self.index("dp")
        return batch[i * b:(i + 1) * b]

    def batch_shard(self) -> Optional[_BatchShard]:
        if self.dp == 1:
            return None
        return _BatchShard(self.groups["dp"], self.index("dp"), self.dp)

    @torch.no_grad()
    def dp_average(self, values: Any) -> Any:
        """The mean over dp of a scalar tensor (or a tuple or dict of
        them): each rank's mean over its equal share of the rows."""
        if isinstance(values, dict):
            keys = list(values)
            return dict(zip(keys, self.dp_average(tuple(values[k]
                                                        for k in keys))))
        if isinstance(values, (tuple, list)):
            if self.dp == 1 or not values:
                return type(values)(v.detach() for v in values)
            flat = torch.stack([v.detach().float().reshape(())
                                for v in values])
            all_reduce(flat, self.groups["dp"]).div_(self.dp)
            return type(values)(f.to(v.dtype)
                                for f, v in zip(flat, values))
        return self.dp_average((values,))[0]

    @torch.no_grad()
    def dp_mean_grads(self, grads: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """The gradients averaged over dp (one all-reduce of them all)."""
        if "dp" not in self.groups:
            return grads
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        all_reduce(flat, self.groups["dp"]).div_(self.axis_size("dp"))
        out, s = [], 0
        for g in grads:
            out.append(flat[s:s + g.numel()].view_as(g).to(g.dtype))
            s += g.numel()
        return out

    @torch.no_grad()
    def global_norm(self, params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm: every replicated parameter once,
        the tp shards' squares summed over tp (each shard once)."""
        rep = [g for p, g in zip(params, grads)
               if getattr(p, "_tp", None) is None]
        shard = [g for p, g in zip(params, grads)
                 if getattr(p, "_tp", None) is not None]
        dev = grads[0].device
        sq = torch.zeros((), device=dev)
        if rep:
            sq = sq + torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(rep))) ** 2
        if shard:
            s = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(shard))) ** 2
            sq = sq + all_reduce(s.reshape(1), self.groups["tp"])[0]
        return torch.sqrt(sq)

    # -- the row-wise sweeps ------------------------------------------
    def row_split(self, axis: Optional[str] = None) -> int:
        """How many chunks a row-wise sweep splits its rows into: over
        ranks the axis's size, or the whole mesh's (axis None, the corpus
        sweeps, which shard over every axis as the JAX package's do); 1
        in a plain process (see the module note)."""
        if not self.distributed:
            return 1
        return self.size if axis is None else self.axis_size(axis)

    def map_rows(self, fn: Callable[..., Sequence[torch.Tensor]],
                 tensors: Sequence[torch.Tensor],
                 axis: Optional[str] = None) -> List[torch.Tensor]:
        """fn over equal chunks of the rows (dim 0) of tensors, its
        outputs concatenated in row order: each rank runs its chunk and
        all-gathers the outputs (equal shapes) over the axis, or the
        whole mesh. The rows must divide into `row_split(axis)` chunks. A
        plain process runs fn on all the rows (see the module note)."""
        if not self.distributed:
            if not self._logged_whole:
                logging.info(
                    "mesh %s in one process: the rows run whole on %s "
                    "(one host thread is slower over several cards than "
                    "on one); ranks split them", self.shape, self.device)
                self._logged_whole = True
            return list(fn(*tensors))
        n = self.row_split(axis)
        rows = tensors[0].shape[0]
        if rows % n:
            raise ValueError(f"{rows} rows do not split into {n} chunks")
        group = dist.group.WORLD if axis is None else self.groups[axis]
        i = dist.get_rank() if axis is None else self.index(axis)
        outs = fn(*(torch.split(t, rows // n)[i] for t in tensors))
        return [torch.cat(all_gather(o.contiguous(), group)) for o in outs]

    # -- tp ------------------------------------------------------------
    @property
    def tp(self) -> int:
        return self.axis_size("tp") if self.distributed else 1

    def tp_rows(self, total: int, name: str) -> slice:
        tp = self.axis_size("tp")
        if total % tp:
            raise ValueError(f"tp={tp} does not divide the {total} rows "
                             f"of {name}")
        r = total // tp
        i = self.index("tp")
        return slice(i * r, (i + 1) * r)

    def tp_shard(self, total: int) -> TP:
        r = total // self.tp
        return TP(self.groups["tp"], self.index("tp"), self.tp,
                  self.index("tp") * r, total)

    def gather_tables(self, model: torch.nn.Module, *opts):
        """The full tables (and the optimizers' moments of them) in place
        of the shards, gathered over tp; returns what was gathered."""
        sharded = [(n, t) for n, t in _tables(model)
                   if getattr(t, "_tp", None) is not None]
        moments = [(opt, i) for opt in opts
                   for i, p in enumerate(opt.params)
                   if getattr(p, "_tp", None) is not None]
        group = self.groups.get("tp")
        for _, t in sharded:
            t.data = torch.cat(all_gather(t.data, group))
        for opt, i in moments:
            opt.mu[i] = torch.cat(all_gather(opt.mu[i], group))
            opt.nu[i] = torch.cat(all_gather(opt.nu[i], group))
        return sharded, moments

    @contextlib.contextmanager
    def unsharded(self, model: torch.nn.Module, *opts) -> Iterator[None]:
        """Inside: the full tables in the model (and the optimizers'
        moments), gathered over tp; after: this rank's rows of what the
        block left there (a codebook re-fit is re-sharded)."""
        sharded, moments = self.gather_tables(model, *opts)
        try:
            yield
        finally:
            for name, t in sharded:
                t.data = t.data[self.tp_rows(t._tp.total, name)].clone()
            for opt, i in moments:
                rows = self.tp_rows(opt.mu[i].shape[0], "moments")
                opt.mu[i] = opt.mu[i][rows].clone()
                opt.nu[i] = opt.nu[i][rows].clone()


def _tables(model: torch.nn.Module):
    """Every (name, parameter or buffer) of a model, each tensor once."""
    seen = set()
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            yield name, t


def _devices(device: torch.device, total: int) -> List[torch.device]:
    if device.type != "cuda":
        return [device] * total
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(total)]


# the axes' process groups of each mesh shape under the running process
# group, held weakly (torch.distributed holds them until it is destroyed):
# a second mesh of a shape reuses their communicators
_GROUPS: Dict[Any, Any] = {}


def _axis_groups(shape: Dict[str, int], rank: int) -> Dict[str, Any]:
    """This rank's process group of each axis. Every rank builds every
    group, in the same order (dist.new_group is collective)."""
    from torch.distributed import distributed_c10d
    default = distributed_c10d._get_default_group()
    key = (id(default), tuple(shape.items()))
    if key in _GROUPS:
        world, refs = _GROUPS[key]
        groups = {axis: ref() for axis, ref in refs.items()}
        if world() is default and None not in groups.values():
            return groups
    sizes = list(shape.values())
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    groups = {}
    for a, axis in enumerate(shape):
        for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    _GROUPS[key] = (weakref.ref(default),
                    {axis: weakref.ref(g) for axis, g in groups.items()})
    return groups


def make_mesh(shape: Optional[Dict[str, int]] = None,
              device=None) -> Optional[Mesh]:
    """shape like {"dp": 4} or {"dp": 2, "tp": 2}; None -> no mesh.
    Raises ValueError when the mesh needs more cards than there are (on
    NCCL or in a plain process, one card a position; gloo ranks may
    share a card) or when a process group of another size is running.
    Inside a process group every rank must call it, in the same order
    (it builds the axes' groups)."""
    if not shape:
        return None
    from gesture2vec_tpu_torch.device import resolve_device
    shape = {str(k): int(v) for k, v in shape.items()}
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh {shape}: every axis needs a size >= 1")
    dev = resolve_device(device)
    total = math.prod(shape.values())
    running = dist.is_available() and dist.is_initialized()
    shared = running and dist.get_backend() == "gloo"
    if dev.type == "cuda" and not shared:
        have = torch.cuda.device_count()
        if have < total:
            raise ValueError(f"mesh {shape} needs {total} devices, have "
                             f"{have}")
    if not running:
        return Mesh(shape, dev, _devices(dev, total))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != total:
        raise ValueError(f"mesh {shape} needs {total} ranks, the process "
                         f"group has {world}")
    sizes = list(shape.values())
    coords = dict(zip(shape, np.unravel_index(rank, sizes)))
    coords = {k: int(v) for k, v in coords.items()}
    groups = _axis_groups(shape, rank)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(shape, dev, _devices(dev, total), groups, coords)


def param_spec(path: str, leaf, mesh: Mesh) -> Optional[str]:
    """The axis a parameter (by its dotted name) shards its rows over:
    "tp" for a table under a tp axis, else None (replicated)."""
    if "tp" in mesh.axis_names:
        for key in _TP_TABLE_KEYS:
            if key in path and getattr(leaf, "ndim", 0) >= 2:
                return "tp"
    return None


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: Optional[Mesh],
                 *opts) -> torch.nn.Module:
    """Keep this rank's rows of every tp table (parameters and buffers,
    a shared tensor once) and of its optimizers' moments; the tensor
    carries its shard as `_tp`. The rest stays replicated."""
    if mesh is None or mesh.tp == 1:
        return model
    for name, t in _tables(model):
        if param_spec(name, t, mesh) is None:
            continue
        rows = mesh.tp_rows(t.shape[0], name)
        for opt in opts:
            for i, p in enumerate(opt.params):
                if p is t:
                    opt.mu[i] = opt.mu[i][rows].clone()
                    opt.nu[i] = opt.nu[i][rows].clone()
        total = t.shape[0]
        t.data = t.data[rows].clone()
        t._tp = mesh.tp_shard(total)
    return model


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of a global batch (the batch itself without a
    mesh)."""
    return batch if mesh is None else mesh.rows(batch)


def prepare_state(model: torch.nn.Module, opts: Sequence[Any],
                  mesh: Optional[Mesh]) -> None:
    """A trainer's state onto its mesh (the JAX package's prepare_state,
    which the port splits: `trainer_mesh` builds the mesh first, since the
    rank's device comes from it): the model's tp tables and their
    optimizers' moments sharded (`shard_params`), and the mesh on every
    optimizer (the dp gradient average and the tp-aware clip norm).
    Nothing without a mesh."""
    if mesh is None:
        return
    shard_params(model, mesh, *opts)
    for opt in opts:
        opt.mesh = mesh


def batch_placer(mesh: Optional[Mesh],
                 device=None) -> Callable[[Any], Any]:
    """Host -> device placement of a global batch: this rank's rows on
    the rank's device under a mesh, the batch on device otherwise."""
    from gesture2vec_tpu_torch.utils.prefetch import place_on
    dev = mesh.device if mesh is not None else torch.device(device or "cpu")
    if mesh is None:
        return lambda x: place_on(x, dev)
    return lambda x: place_on(mesh.rows(x), dev)


# -- what a trainer calls (each takes mesh None for the single run) ------
def trainer_mesh(mesh_shape: Optional[Dict[str, int]], device
                 ) -> "tuple[Optional[Mesh], torch.device]":
    """(the mesh of a config's mesh_shape, the device this rank trains
    on); (None, the device) without one."""
    from gesture2vec_tpu_torch.device import resolve_device
    mesh = make_mesh(mesh_shape, device) if mesh_shape else None
    return mesh, (mesh.device if mesh is not None
                  else resolve_device(device))


def shard_context(mesh: Optional[Mesh]):
    """The step's `models/layers.batch_shard` over the mesh's dp axis."""
    from gesture2vec_tpu_torch.models.layers import batch_shard
    return batch_shard(None if mesh is None else mesh.batch_shard())


def average(mesh: Optional[Mesh], values: Any) -> Any:
    """A loss or metric of this rank's rows as the global batch's."""
    return values if mesh is None else mesh.dp_average(values)


def is_main(mesh: Optional[Mesh]) -> bool:
    """The rank that logs its history and writes the files."""
    return mesh is None or mesh.is_main


def gathered(mesh: Optional[Mesh], model: torch.nn.Module, *opts):
    """`Mesh.unsharded` (a checkpoint's full tables); nothing without a
    mesh. Every rank enters it."""
    if mesh is None:
        return contextlib.nullcontext()
    return mesh.unsharded(model, *opts)


@torch.no_grad()
def finish(mesh: Optional[Mesh], model: torch.nn.Module, *opts
           ) -> torch.nn.Module:
    """The model with its full tables again (every rank), its optimizers
    leaving the mesh: what a trainer returns."""
    if mesh is None:
        return model
    sharded, _ = mesh.gather_tables(model, *opts)
    for _, t in sharded:
        del t._tp
    for opt in opts:
        opt.mesh = None
    return model
