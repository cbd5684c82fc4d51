"""Pipeline parallelism (GPipe microbatching) over a "pp" mesh axis.

Port of the JAX package's `parallel/pipeline.py`. Every pp rank holds
one stage; the batch (this dp rank's rows of it under a "dp" axis)
splits into n_micro microbatches that stream through the stages over
n_micro + n_stages - 1 ticks: at each tick a stage takes its input (the
batch's microbatch on stage 0, else the activation its predecessor sent
at the previous tick), applies its stage and sends the result on with
`dist.isend` / `irecv`, a point-to-point hop (`parallel/mesh.send` and
`recv`: over gloo a CUDA activation goes through pinned host memory).
The last stage collects the outputs and broadcasts them over pp, and
the dp ranks gather their rows, so every rank holds the whole result,
as the JAX package's masked psum leaves it.

PyTorch's autograd does not cross a send or a recv, so the pipeline is
one `torch.autograd.Function` with an explicit backward schedule: each
stage keeps its microbatches' graphs from the forward, and the backward
runs the ticks in the same order from the last stage down, each stage
receiving the gradient of its output from its successor, differentiating
its own graph and sending the gradient of its input back. The stacked
parameters' gradient is this rank's stage's slice summed over the pp
and dp ranks, so every rank holds all of it, as it holds the stacked
parameters; the input's gradient is gathered as the output is.

Stages are shape-uniform (stage_fn(params_i, x) returns x's shape).
`pipelined_gru_stack` makes each stage one GRU layer (`models/gru.
gru_layer`): on the card its forward is the GRU-sequence kernel's
gate-saving variant and its backward the GRU backward kernel
(`GRUSequenceFn`). Without a process group (a plain process) the stages
run one after the other on the batch, a microbatch at a time.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from gesture2vec_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                                 all_reduce, broadcast,
                                                 recv, send)

Params = Dict[str, torch.Tensor]


def stack_stages(params_list: Sequence[Params]) -> Params:
    """Stack per-stage parameter dicts along a new leading axis (the
    axis gpipe splits over "pp")."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def _neighbour(mesh: Mesh, axis: str, step: int) -> int:
    """The global rank of this rank's neighbour step along axis."""
    coords = dict(mesh.coords)
    coords[axis] += step
    rank = 0
    for a in mesh.axis_names:
        rank = rank * mesh.shape[a] + coords[a]
    return rank


def _stage_rank(mesh: Mesh, axis: str, stage: int) -> int:
    return _neighbour(mesh, axis, stage - mesh.index(axis))


class _GPipe(torch.autograd.Function):
    """(x, *stacked parameters) -> the stack's output over the pipeline
    (see the module note)."""

    @staticmethod
    def forward(ctx, stage_fn, mesh, n_micro, axis, batch_axis, keys, x,
                *stacked):
        S, s = mesh.shape[axis], mesh.index(axis)
        dp = batch_axis in mesh.axis_names
        xl = mesh.rows(x) if dp else x
        b = xl.shape[0] // n_micro
        micro = list(torch.split(xl, b))
        params = [p[s].detach().requires_grad_() for p in stacked]
        ctx.saved = []                      # (input, output) a microbatch
        outs: List[torch.Tensor] = []
        pending = []
        for t in range(n_micro + S - 1):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            x_in = micro[m] if s == 0 else recv(micro[0], _neighbour(
                mesh, axis, -1))
            x_in = x_in.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(dict(zip(keys, params)), x_in)
            ctx.saved.append((x_in, y))
            if s < S - 1:
                pending.append(send(y.detach(), _neighbour(mesh, axis, 1)))
            else:
                outs.append(y.detach())
        for work in pending:
            work.wait()
        out = torch.cat(outs) if s == S - 1 else torch.empty_like(xl)
        broadcast(out, _stage_rank(mesh, axis, S - 1), mesh.groups[axis])
        if dp:
            out = torch.cat(all_gather(out, mesh.groups[batch_axis]))
        ctx.mesh, ctx.axis, ctx.batch_axis = mesh, axis, batch_axis
        ctx.n_micro, ctx.params, ctx.dp = n_micro, params, dp
        ctx.shapes = [p.shape for p in stacked]
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh, axis = ctx.mesh, ctx.axis
        S, s = mesh.shape[axis], mesh.index(axis)
        n_micro = ctx.n_micro
        gl = mesh.rows(grad) if ctx.dp else grad
        micro = list(torch.split(gl.contiguous(), gl.shape[0] // n_micro))
        pgrads = [torch.zeros_like(p) for p in ctx.params]
        gx: List[torch.Tensor] = []
        pending = []
        for t in range(n_micro + S - 1):
            m = t - (S - 1 - s)
            if not 0 <= m < n_micro:
                continue
            x_in, y = ctx.saved[m]
            g = micro[m] if s == S - 1 else recv(y, _neighbour(mesh, axis,
                                                                1))
            got = torch.autograd.grad(y, [x_in] + ctx.params, g,
                                      allow_unused=True)
            for acc, d in zip(pgrads, got[1:]):
                if d is not None:
                    acc.add_(d)
            if s > 0:
                pending.append(send(got[0], _neighbour(mesh, axis, -1)))
            else:
                gx.append(got[0])
        for work in pending:
            work.wait()
        ctx.saved = None
        dx = torch.cat(gx) if s == 0 else torch.empty_like(gl)
        broadcast(dx, _stage_rank(mesh, axis, 0), mesh.groups[axis])
        if ctx.dp:
            dx = torch.cat(all_gather(dx, mesh.groups[ctx.batch_axis]))
        full = []
        for shape, d in zip(ctx.shapes, pgrads):
            f = d.new_zeros(shape)
            f[s] = d
            all_reduce(f, mesh.groups[axis])
            if ctx.dp:
                all_reduce(f, mesh.groups[ctx.batch_axis])
            full.append(f)
        return (None, None, None, None, None, None, dx, *full)


def _sequential(stage_fn, stacked: Params, x: torch.Tensor,
                n_micro: int) -> torch.Tensor:
    """The plain process's schedule: each microbatch through every stage."""
    S = next(iter(stacked.values())).shape[0]
    outs = []
    for xm in torch.split(x, x.shape[0] // n_micro):
        for i in range(S):
            xm = stage_fn({k: v[i] for k, v in stacked.items()}, xm)
        outs.append(xm)
    return torch.cat(outs)


def gpipe_fn(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
             mesh: Mesh, n_micro: int, axis: str = "pp",
             batch_axis: str = "dp"
             ) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """f(stacked_params, x) -> y running the GPipe schedule over the
    mesh's axis. stage_fn(params_i, x) returns x's shape and dtype;
    stacked_params' tensors carry a leading n_stages axis
    (stack_stages); x is (B, ...), the whole batch on every rank, with B
    divisible by n_micro (and by n_micro times the dp axis)."""

    def f(stacked_params: Params, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        dp = mesh.axis_size(batch_axis)
        if b % n_micro or b % (n_micro * dp):
            raise ValueError(f"batch {b} not divisible by n_micro "
                             f"{n_micro} x {batch_axis} {dp}")
        stages = next(iter(stacked_params.values())).shape[0]
        if stages != mesh.axis_size(axis):
            raise ValueError(f"{stages} stages for a {axis} axis of "
                             f"{mesh.axis_size(axis)}")
        if not mesh.distributed:
            return _sequential(stage_fn, stacked_params, x, n_micro)
        keys = sorted(stacked_params)
        return _GPipe.apply(stage_fn, mesh, n_micro, axis, batch_axis,
                            keys, x, *(stacked_params[k] for k in keys))

    return f


def gpipe(stage_fn, stacked_params: Params, x: torch.Tensor, *,
          mesh: Mesh, n_micro: int, axis: str = "pp",
          batch_axis: str = "dp") -> torch.Tensor:
    """One-shot convenience wrapper over gpipe_fn."""
    return gpipe_fn(stage_fn, mesh, n_micro, axis, batch_axis)(
        stacked_params, x)


def gru_stage(w: Params, x: torch.Tensor) -> torch.Tensor:
    """One GRU layer on batch-major (B, T, H) from a zero hidden
    (`models/gru.gru_layer`, torch.nn.GRU's default)."""
    from gesture2vec_tpu_torch.models.gru import gru_layer
    h0 = x.new_zeros((x.shape[0], w["w_hh"].shape[1]))
    ys, _ = gru_layer(x.transpose(0, 1), h0, w["w_ih"], w["w_hh"],
                      w["b_ih"], w["b_hh"])
    return ys.transpose(0, 1)


def pipelined_gru_stack(xs_bm: torch.Tensor, stacked_weights: Params, *,
                        mesh: Mesh, n_micro: int, axis: str = "pp",
                        batch_axis: str = "dp") -> torch.Tensor:
    """Deep uniform GRU stack, one layer a pipeline stage. xs_bm (B, T, H)
    batch-major hidden-width sequences; stacked_weights w_ih (S, 3H, H),
    w_hh (S, 3H, H), b_ih / b_hh (S, 3H). Returns the top layer's
    outputs (B, T, H)."""
    return gpipe(gru_stage, stacked_weights, xs_bm, mesh=mesh,
                 n_micro=n_micro, axis=axis, batch_axis=batch_axis)


def dense_stage(p: Params, x: torch.Tensor) -> torch.Tensor:
    """tanh(x @ w + b): the JAX package's pipeline tests' stage."""
    return torch.tanh(x @ p["w"] + p["b"])


_STAGES = {"dense": dense_stage, "gru": gru_stage}


def run_stack(stage: str, stacked: Params, x: torch.Tensor,
              target: torch.Tensor, mesh_shape: Dict[str, int],
              n_micro: int, device: Any = "cpu") -> Dict[str, Any]:
    """A rank's run of a named stage's pipeline (`parallel/launch.run`):
    the output and the gradients of mean((y - target)^2) with respect to
    the stacked parameters and the input, on every rank."""
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_shape, device)
    dev = mesh.device
    stacked = {k: v.to(dev).clone().requires_grad_()
               for k, v in stacked.items()}
    x = x.to(dev).clone().requires_grad_()
    y = gpipe(_STAGES[stage], stacked, x, mesh=mesh, n_micro=n_micro)
    loss = torch.mean((y - target.to(dev)) ** 2)
    loss.backward()
    return {"y": y.detach().cpu(), "loss": loss.detach().cpu(),
            "grads": {k: v.grad.cpu() for k, v in stacked.items()},
            "x_grad": x.grad.cpu()}
