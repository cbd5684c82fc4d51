"""The trainers' optimizer: optax.chain(clip_by_global_norm(5),
adam(lr, b1=0.5, b2=0.999, eps=1e-8)), as the JAX package's
`train/optim.make_optimizer` builds it.

Clipping is optax's: the updates are scaled by clip / norm only when the
global norm is at least clip, with no epsilon (torch's
clip_grad_norm_ divides by norm + 1e-6). Adam is optax's scale_by_adam:
mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, count += 1, and the
step -lr * mu_hat / (sqrt(nu_hat) + eps) with mu_hat = mu / (1 -
b1^count), nu_hat = nu / (1 - b2^count). The state (count, mu, nu) maps
onto optax's state dict ({"0": {}, "1": {"0": {"count", "mu", "nu"},
"1": {}}}) through the models' JAX layouts (`compat/from_jax`).

Under a mesh (`mesh`, set by `parallel/mesh.prepare_state`) the step
first averages the gradients over the dp ranks, and the clip's global
norm counts every replicated parameter once and every tp shard once
(`parallel/mesh.Mesh.global_norm`); a shard's moments stay with it.
`Step` returns the loss averaged over dp, the global batch's. A step is
the span g2v.step, its phases g2v.step.forward, .backward and .optim
(`utils/profiling.annotate`).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import torch

from gesture2vec_tpu_torch.utils.profiling import annotate


class Adam:
    """Clipped Adam over a list of parameters; a parameter without a
    gradient counts as a zero gradient, as JAX's are."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, clip_norm: Optional[float] = 5.0,
                 b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8):
        seen, self.params = set(), []
        for p in params:
            if id(p) not in seen:
                seen.add(id(p))
                self.params.append(p)
        self.lr, self.clip_norm = learning_rate, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mesh = None
        self.mu: List[torch.Tensor] = [torch.zeros_like(p)
                                       for p in self.params]
        self.nu: List[torch.Tensor] = [torch.zeros_like(p)
                                       for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' .grad; returns the global
        gradient norm (before clipping)."""
        g = self.grads()
        if self.mesh is not None:
            g = self.mesh.dp_mean_grads(g)
        if self.mesh is not None and self.mesh.tp > 1:
            norm = self.mesh.global_norm(self.params, g)
        else:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
        if self.clip_norm is not None:
            # optax: keep when norm < clip, else (g / norm) * clip
            scale = torch.where(norm < self.clip_norm, norm.new_ones(()),
                                self.clip_norm / norm)
            g = torch._foreach_mul(g, scale)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - b2))
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        torch._foreach_add_(self.params, torch._foreach_div(mu_hat, denom),
                            alpha=-self.lr)
        return norm


class Step:
    """One optimizer step on a batch: a subclass's `loss(*batch)` is the
    forward and returns the loss, or (loss, a metric); calling the step
    adds the backward and the update of `self.opt` and returns the same,
    detached (on the device)."""

    opt: Adam

    def loss(self, *batch):
        raise NotImplementedError

    def __call__(self, *batch) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                            ...]]:
        with annotate("step"):
            self.opt.zero_grad()
            with annotate("step.forward"):
                out = self.loss(*batch)
            with annotate("step.backward"):
                (out[0] if isinstance(out, tuple) else out).backward()
            with annotate("step.optim"):
                self.opt.step()
            if self.opt.mesh is not None:
                return self.opt.mesh.dp_average(out)
            if isinstance(out, tuple):
                return tuple(t.detach() for t in out)
            return out.detach()
