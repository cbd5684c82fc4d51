"""The epoch / validation / checkpoint loop of the token trainers (the
port's copy of the JAX package's `train/token_loop.py`): the batch order
of each epoch is np.random.default_rng(seed + epoch).permutation(n), as
in JAX, so both packages see the same batches; the trailing partial
batch is dropped; losses stay on the device until the epoch's mean;
validation sweeps the full batches of the validation set; keep_best
snapshots the best-validation-loss state, saves it under the "best" tag
and returns it instead of the final epoch's. A second step
(`train_step_late`, the feedback-matched finetune) takes over from epoch
`late_from_epoch` on, a run resumed inside that phase included; the
switch is logged once a run. Under a mesh (`parallel/mesh`) each dp rank
takes its rows of every global batch, the losses and accuracies are the
global batch's, and rank 0 writes the checkpoints (the tables gathered
over tp).
"""
from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gesture2vec_tpu_torch.models.layers import dropout_generator
from gesture2vec_tpu_torch.parallel import mesh as pmesh
from gesture2vec_tpu_torch.train.config import Config
from gesture2vec_tpu_torch.train.optim import Adam
from gesture2vec_tpu_torch.utils.meters import AverageMeter


def require_full_batch(n: int, batch_size: int, part: str) -> None:
    """Fail instead of training zero batches an epoch: every loop drops
    the trailing partial batch."""
    if n < batch_size:
        raise ValueError(
            f"{part} training needs at least one full batch: "
            f"{n} samples < batch_size {batch_size} "
            f"(lower config.batch_size or provide more data)")


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A batch on the device: integer arrays as int64 (indices), floats as
    float32."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.long() if np.issubdtype(a.dtype, np.integer) else t.float()
    return t.to(device, non_blocking=True)


def snapshot(model: torch.nn.Module, opt: Adam,
             generator: torch.Generator) -> dict:
    """A copy of the training state on the host."""
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
            "count": opt.count,
            "mu": [m.detach().cpu().clone() for m in opt.mu],
            "nu": [v.detach().cpu().clone() for v in opt.nu],
            "generator": generator.get_state()}


@torch.no_grad()
def restore(model: torch.nn.Module, opt: Adam, generator: torch.Generator,
            snap: dict) -> None:
    model.load_state_dict(snap["model"])
    opt.count = snap["count"]
    for dst, src in zip(opt.mu + opt.nu, snap["mu"] + snap["nu"]):
        dst.copy_(src)
    generator.set_state(snap["generator"])


def run_token_training(config: Config, model: torch.nn.Module, opt: Adam,
                       generator: torch.Generator, start_epoch: int,
                       fields: Sequence[str], data: Dict[str, np.ndarray],
                       val_data: Dict[str, np.ndarray],
                       train_step: Callable, eval_step: Callable,
                       device: torch.device,
                       save_checkpoint: Callable[..., None],
                       save_every: int, log_every: int,
                       train_step_late: Optional[Callable] = None,
                       late_from_epoch: Optional[int] = None,
                       mesh: Optional[pmesh.Mesh] = None
                       ) -> Dict[str, List[float]]:
    """train_step(*batch) -> loss tensor (one optimizer step), and
    train_step_late the same from epoch late_from_epoch on;
    eval_step(*batch) -> (loss, acc, pred); save_checkpoint(epoch_1based,
    tag=None) writes the live state. Leaves the model in the returned
    state (the best epoch's with keep_best) and returns the history."""
    seed = max(config.random_seed, 0)
    n, bs = data[fields[0]].shape[0], config.batch_size
    require_full_batch(n, bs, config.name)
    if mesh is not None:
        mesh.check_batch(bs)

    def save(epoch1: int, tag: Optional[str] = None) -> None:
        with pmesh.gathered(mesh, model, opt):
            if pmesh.is_main(mesh):
                save_checkpoint(epoch1, tag=tag)

    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                       "val_acc": []}
    meter = AverageMeter("loss", ":.4f")
    keep_best = bool(config.keep_best)
    best_loss, best, best_epoch = float("inf"), None, -1

    switched = False
    for epoch in range(start_epoch, config.epochs):
        step_fn = train_step
        if train_step_late is not None and epoch >= late_from_epoch:
            if not switched:
                logging.info("EP %d: switching to the feedback-matched "
                             "finetune step", epoch)
                switched = True
            step_fn = train_step_late
        perm = np.random.default_rng(seed + epoch).permutation(n)
        meter.reset()
        t0 = time.time()
        losses = []
        model.train()
        for b in range(n // bs):
            take = pmesh.shard_batch(perm[b * bs:(b + 1) * bs], mesh)
            with dropout_generator(generator), pmesh.shard_context(mesh):
                loss = step_fn(*(to_device(data[f][take], device)
                                 for f in fields))
            losses.append(loss)
            if (b + 1) % log_every == 0:
                block = float(torch.stack(losses[-log_every:]).mean())
                meter.update(block, bs * log_every)
                logging.info("EP %d (%d) %s, %.0f samples/s", epoch, b + 1,
                             meter, (b + 1) * bs / (time.time() - t0))
        epoch_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        meter.avg = epoch_loss
        history["train_loss"].append(epoch_loss)
        if losses and "first_step_loss" not in history:
            history["first_step_loss"] = [float(losses[0])]

        model.eval()
        vl, va = [], []
        m = val_data[fields[0]].shape[0]
        for s in range(0, m - bs + 1, bs):
            loss, acc = pmesh.average(mesh, eval_step(*(to_device(
                pmesh.shard_batch(val_data[f][s:s + bs], mesh), device)
                for f in fields))[:2])
            vl.append(float(loss))
            va.append(float(acc))
        history["val_loss"].append(float(np.mean(vl)) if vl
                                   else float("nan"))
        history["val_acc"].append(float(np.mean(va)) if va
                                  else float("nan"))
        logging.info("EP %d done: train %.4f val %.4f acc %.3f", epoch,
                     meter.avg, history["val_loss"][-1],
                     history["val_acc"][-1])
        vloss = history["val_loss"][-1]
        if keep_best and vloss == vloss and vloss < best_loss:
            best_loss, best_epoch = vloss, epoch
            best = snapshot(model, opt, generator)
        if (epoch + 1) % save_every == 0 or epoch + 1 == config.epochs:
            save(epoch + 1)

    if keep_best and best is not None:
        history["best_epoch"] = [best_epoch]
        history["best_val_loss"] = [best_loss]
        restore(model, opt, generator, copy.deepcopy(best))
        save(best_epoch + 1, tag="best")
        logging.info("keep_best: returning epoch %d (val %.4f) instead of "
                     "the final epoch", best_epoch, best_loss)
    return history
