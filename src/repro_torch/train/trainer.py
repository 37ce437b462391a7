"""Trainer: the step factory and the training loop, the port of the JAX
package's ``train/trainer.py``, on one device or on a mesh.

``make_train_step`` builds the step: gradients of ``model.loss`` (summed in
float32 over ``grad_accum`` micro-batches, as the reference's scan does),
optional int8 gradient compression, global-norm clipping, AdamW or
Adafactor (its update clip over the reference's stacked leaves), and the
update added to each parameter in its dtype.  The step runs eagerly.

Under a sharding context on a mesh (:mod:`repro_torch.distributed.sharding`,
``with activate(ctx):``) the same step runs SPMD on DTensors: the
:class:`Trainer` lays the parameters out by ``model.param_logical_axes()``,
the batch is sharded over the batch axes (each micro-batch of a
``grad_accum`` split too: the accum axis replicated, the batch sharded),
the gradients are anchored to their parameters' placements before
anything touches them (:func:`_constrain_like_params`, which is where the
data-parallel all-reduce happens), the global norm is taken over the full
gradients, and after the update the optimizer state is laid out by its
ZeRO specs (:mod:`repro_torch.distributed.zero`).

The models' parameters are frozen for serving (``layers.param``);
:func:`trainable` is the one place that makes them trainable.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config import ArchConfig, TrainConfig
from repro_torch.distributed.collectives import int8_roundtrip
from repro_torch.distributed.sharding import (
    current_context,
    distribute_params,
    full_tensor,
    shard,
)
from repro_torch.distributed.zero import zero_shard_opt_state, zero_specs
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


def _constrain_like_params(grads: Mapping[str, torch.Tensor], params: Params
                           ) -> Dict[str, torch.Tensor]:
    """Redistribute each gradient to its parameter's placements (the
    reference's anchor: model-sharded, data-replicated): a partial sum
    becomes its all-reduce."""
    out = {}
    for k, g in grads.items():
        p = params[k]
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out[k] = g
    return out


def make_train_step(model: nn.Module, train_cfg: TrainConfig
                    ) -> Callable[[Params, OptState, Batch, int],
                                  Tuple[Params, OptState, Dict[str, torch.Tensor]]]:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).
    ``params`` are the model's own (:func:`trainable`) and are updated in
    place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``."""
    _, opt_update = OPTIMIZERS[train_cfg.optimizer]
    accum = max(train_cfg.grad_accum, 1)
    stacks = reference_stacks(dict(model.named_parameters()), model.cfg)
    zspecs = {}  # the ZeRO specs per mesh and rules, computed on first use

    def step_fn(params: Params, opt_state: OptState, batch: Batch, step: int):
        ctx = current_context()
        if ctx is not None and ctx.distributed:
            batch = {k: v if isinstance(v, DTensor)
                     else ctx.distribute(v, ("batch",) + (None,) * (v.ndim - 1))
                     for k, v in batch.items()}
        if accum == 1:
            loss, _, grads = value_and_grad(model, params, batch)
        else:
            # micro-batch i is rows [i*B/accum, (i+1)*B/accum), the reference's
            # reshape [B, ...] -> [accum, B/accum, ...]; on a mesh the reshape
            # could land the batch sharding on the accum axis: pin it, the
            # accum axis replicated and the batch sharded
            def split(v):
                if isinstance(v, DTensor) and any(p.is_shard(0) for p in v.placements):
                    # the batch whole on each rank first (token ids: small), so
                    # that the reshape never asks the accum axis to take the
                    # batch's sharding, which it cannot when accum does not
                    # divide the batch shards
                    v = v.redistribute(v.device_mesh, [Replicate() if p.is_shard(0) else p
                                                       for p in v.placements])
                y = v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                return shard(y, None, "batch", *([None] * (y.ndim - 2)))

            micros = {k: split(v) for k, v in batch.items()}
            loss = grads = None
            for i in range(accum):
                l, _, g = value_and_grad(model, params, {k: v[i] for k, v in micros.items()})
                if grads is None:
                    loss = torch.zeros_like(l, dtype=torch.float32)
                    grads = {k: torch.zeros_like(p, dtype=torch.float32)
                             for k, p in params.items()}
                loss = loss + l
                for k in grads:
                    grads[k].add_(g[k])
            loss = loss / accum
            grads = {k: g / accum for k, g in grads.items()}
        if train_cfg.grad_compression == "int8":
            grads = int8_roundtrip(grads)
        if ctx is not None and ctx.distributed:
            grads = _constrain_like_params(grads, params)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        updates, opt_state = opt_update(grads, opt_state, params, step, train_cfg, stacks)
        if ctx is not None and ctx.distributed:
            key = (tuple(ctx.mesh.mesh_dim_names), tuple(ctx.mesh.shape),
                   tuple(sorted(ctx.rules.items())))
            if key not in zspecs:
                zspecs[key] = zero_specs(opt_state, model.param_logical_axes(), ctx, model.cfg)
            opt_state = zero_shard_opt_state(opt_state, model.param_logical_axes(), ctx,
                                             zspecs[key])
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        # keys in the order of the reference's (jitted, so key-sorted) dict
        return params, opt_state, {"grad_norm": full_tensor(gnorm), "loss": full_tensor(loss),
                                   "lr": lr_schedule(train_cfg, step)}

    return step_fn


class Trainer:
    """Single-process training loop with checkpoint/resume.

    Trains ``model`` (built on its device by ``models.api.get_model``) with
    the weights it holds, or with random ones drawn from ``generator``
    (``model.init``), or with the state dict ``params``.  Built inside an
    active sharding context on a mesh, it lays the parameters out by the
    context (every rank holds the same full weights first: the same seed or
    state dict) and the optimizer state by its ZeRO specs."""

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
        ctx = current_context()
        if ctx is not None and ctx.distributed:
            distribute_params(model, ctx)
        self.params = trainable(model)
        opt_init, _ = OPTIMIZERS[train_cfg.optimizer]
        self.opt_state = opt_init(self.params)
        if ctx is not None and ctx.distributed:
            self.opt_state = zero_shard_opt_state(self.opt_state, model.param_logical_axes(), ctx)
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
