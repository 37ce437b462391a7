"""Trainer: the step factory and the training loop, the port of the JAX
package's ``train/trainer.py`` on one device.

``make_train_step`` builds the step: gradients of ``model.loss`` (summed in
float32 over ``grad_accum`` micro-batches, as the reference's scan does),
optional int8 gradient compression, global-norm clipping, AdamW or
Adafactor (its update clip over the reference's stacked leaves), and the
update added to each parameter in its dtype.  The step
runs eagerly.  The reference's ZeRO and gradient-anchoring branches run
only under a sharding context, that is on a mesh of several devices:
ROADMAP P16b.

The models' parameters are frozen for serving (``layers.param``);
:func:`trainable` is the one place that makes them trainable.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ArchConfig, TrainConfig
from repro_torch.distributed.collectives import int8_roundtrip
from repro_torch.models.bridge import reference_stacks
from repro_torch.train.optimizer import OPTIMIZERS, OptState, clip_by_global_norm, lr_schedule

Params = Dict[str, nn.Parameter]
Batch = Mapping[str, torch.Tensor]


def trainable(model: nn.Module) -> Params:
    """The model's parameters by name, each made to require gradients."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def value_and_grad(model: nn.Module, params: Params, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(loss, the loss's aux dict, {name: gradient in the parameter's
    dtype}) of ``model.loss(batch)``; a parameter the loss does not reach
    gets a zero gradient, as under ``jax.grad``."""
    with torch.enable_grad():
        loss, aux = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(params, grads))


def make_train_step(model: nn.Module, train_cfg: TrainConfig
                    ) -> Callable[[Params, OptState, Batch, int],
                                  Tuple[Params, OptState, Dict[str, torch.Tensor]]]:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).
    ``params`` are the model's own (:func:`trainable`) and are updated in
    place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``."""
    _, opt_update = OPTIMIZERS[train_cfg.optimizer]
    accum = max(train_cfg.grad_accum, 1)
    stacks = reference_stacks(dict(model.named_parameters()), model.cfg)

    def step_fn(params: Params, opt_state: OptState, batch: Batch, step: int):
        if accum == 1:
            loss, _, grads = value_and_grad(model, params, batch)
        else:
            # micro-batch i is rows [i*B/accum, (i+1)*B/accum), the reference's
            # reshape [B, ...] -> [accum, B/accum, ...]
            mb = batch["tokens"].shape[0] // accum
            dev = next(iter(params.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in params.items()}
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = value_and_grad(model, params, micro)
                loss = loss + l
                for k in grads:
                    grads[k].add_(g[k])
            loss = loss / accum
            grads = {k: g / accum for k, g in grads.items()}
        if train_cfg.grad_compression == "int8":
            grads = int8_roundtrip(grads)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        updates, opt_state = opt_update(grads, opt_state, params, step, train_cfg, stacks)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        # keys in the order of the reference's (jitted, so key-sorted) dict
        return params, opt_state, {"grad_norm": gnorm, "loss": loss,
                                   "lr": lr_schedule(train_cfg, step)}

    return step_fn


class Trainer:
    """Single-process training loop with checkpoint/resume.

    Trains ``model`` (built on its device by ``models.api.get_model``) with
    the weights it holds, or with random ones drawn from ``generator``
    (``model.init``), or with the state dict ``params``."""

    def __init__(self, model: nn.Module, train_cfg: TrainConfig, *,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, ckpt_manager=None):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.train_cfg = train_cfg
        if params is not None:
            model.load_state_dict(params)
        elif generator is not None:
            model.init(generator)
        self.device = model.device
        self.params = trainable(model)
        opt_init, _ = OPTIMIZERS[train_cfg.optimizer]
        self.opt_state = opt_init(self.params)
        self.step = 0
        self.ckpt = ckpt_manager
        self._step_fn = make_train_step(model, train_cfg)
        self.history = []

    def maybe_resume(self) -> bool:
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore_latest(self.params, self.opt_state)
        if restored is None:
            return False
        self.step = restored["step"]
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(restored["params"][k])
        self.opt_state = restored["opt_state"]
        return True

    def train(self, batches: Iterator[Batch], num_steps: int, log_every: int = 10) -> list:
        """``num_steps`` steps over ``batches`` (dicts of CPU tensors or
        arrays, placed on the trainer's device here).  Logs a history row
        ({grad_norm, loss, lr, step, wall}) at step 1 and every
        ``log_every`` steps, and checkpoints every ``checkpoint_every``."""
        t0 = time.perf_counter()
        for _ in range(num_steps):
            batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                     for k, v in next(batches).items()}
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            self.step += 1
            if self.step % log_every == 0 or self.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                m["wall"] = round(time.perf_counter() - t0, 2)
                self.history.append(m)
            if self.ckpt is not None and self.step % self.train_cfg.checkpoint_every == 0:
                self.ckpt.save(self.step, self.params, self.opt_state)
        return self.history
