"""Optimizers as pure functions on dicts of tensors, the port of the JAX
package's ``train/optimizer.py`` (no ``torch.optim``).

Parameters, gradients and optimizer state are dicts keyed by the port's
parameter names (``model.named_parameters()``).  Every function runs under
``torch.no_grad()`` and returns new tensors; the trainer applies the
updates.  The step's scalars (learning rate, bias corrections) are 0-dim
float32 CPU tensors, which PyTorch passes to a card's kernels as
arguments.  Weight decay applies to every leaf, norms included, as the
reference's does: there are no parameter groups.

* AdamW: float32 moments ``{"m", "v"}``.
* Adafactor-style "lite": a bfloat16 first moment and a second moment
  factored into row and column means for every leaf whose last two axes
  are both at least 128 (``{"row", "col"}``), a float32 leaf otherwise,
  and the RMS-1 update clip.  The reference takes that clip's RMS over
  each leaf of its tree, where one leaf stacks a parameter over the layers
  of its kind; ``stacks`` (``models.bridge.reference_stacks``) names those
  groups, so that the port clips as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.config import TrainConfig
from repro_torch.distributed.sharding import full_tensor

Tensors = Dict[str, torch.Tensor]
OptState = Dict[str, Dict[str, Union[torch.Tensor, Tensors]]]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@torch.no_grad()
def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in float32 (a 0-dim CPU
    tensor)."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * prog)
    return cfg.learning_rate * warm * cos


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """x's float32 sum of squares; of a DTensor (a leaf sharded over a
    mesh), its full value, the same on every rank."""
    return full_tensor(x.float().square().sum())


@torch.no_grad()
def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (over the full leaves on a mesh)."""
    return torch.sqrt(torch.stack([_sum_sq(x) for x in tree.values()]).sum())


@torch.no_grad()
def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / norm)``, keeping each leaf's
    dtype (the reference keeps it: a float32 copy of a large model's grads
    would dominate memory).  Returns (clipped, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@torch.no_grad()
def adamw_init(params: Mapping[str, torch.Tensor]) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()}}


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Mapping[str, torch.Tensor], step, cfg: TrainConfig,
                 stacks: Optional[Sequence[Sequence[str]]] = None
                 ) -> Tuple[Tensors, OptState]:
    """Returns (updates in each parameter's dtype, new state); ``stacks``
    is unused (AdamW works element by element)."""
    b1, b2 = cfg.beta1, cfg.beta2
    lr = lr_schedule(cfg, step)
    t = _f32(step) + 1.0
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    updates, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        p = params[k]
        g = g.float()
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g.square()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + cfg.weight_decay * p.float()
        updates[k] = (-lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return updates, {"m": new_m, "v": new_v}


# ---------------------------------------------------------------------------
# Adafactor-style "lite" (bf16 m + factored v)
# ---------------------------------------------------------------------------


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


@torch.no_grad()
def adafactor_init(params: Mapping[str, torch.Tensor]) -> OptState:
    def v_init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return torch.zeros(p.shape, **f32)

    return {"m": {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                  for k, p in params.items()},
            "v": {k: v_init(p) for k, p in params.items()}}


@torch.no_grad()
def adafactor_update(grads: Mapping[str, torch.Tensor], state: OptState,
                     params: Mapping[str, torch.Tensor], step, cfg: TrainConfig,
                     stacks: Optional[Sequence[Sequence[str]]] = None
                     ) -> Tuple[Tensors, OptState]:
    """Returns (updates in each parameter's dtype, new state).  The update
    clip's RMS is taken over each group of ``stacks`` (each leaf alone when
    None)."""
    b1 = cfg.beta1
    b2 = 1.0 - (_f32(step) + 1.0) ** -0.8
    lr = lr_schedule(cfg, step)
    us, new_v = {}, {}
    for k, g in grads.items():
        p, v = params[k], state["v"][k]
        g2 = g.float().square() + 1e-30
        if _factored(p):
            row = b2 * v["row"] + (1 - b2) * g2.mean(dim=-1)
            col = b2 * v["col"] + (1 - b2) * g2.mean(dim=-2)
            row_mean = row.mean(dim=-1, keepdim=True)
            vhat = (row / torch.clamp(row_mean, min=1e-30))[..., None] * col[..., None, :]
            new_v[k] = {"row": row, "col": col}
        else:
            vhat = b2 * v + (1 - b2) * g2
            new_v[k] = vhat
        us[k] = g.float() / torch.sqrt(vhat + 1e-30)
    updates, new_m = {}, {}
    for group in stacks if stacks is not None else [[k] for k in grads]:
        # Adafactor's RMS-1 update clip, over the group
        n = sum(us[k].numel() for k in group)
        rms = torch.sqrt(torch.stack([_sum_sq(us[k]) for k in group]).sum() / n + 1e-30)
        for k in group:
            p = params[k]
            m32 = b1 * state["m"][k].float() + (1 - b1) * us[k] / torch.clamp(rms, min=1.0)
            updates[k] = (-lr * (m32 + cfg.weight_decay * p.float())).to(p.dtype)
            new_m[k] = m32.to(torch.bfloat16)
    return updates, {"m": new_m, "v": new_v}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}
