"""Checks of multi-device training over the launcher's world: four cards
(``nccl``), or four CPU processes with ``--device cpu`` (``gloo``).

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.distributed.mesh_check

On a ``(world / 2) x 2`` data x model mesh, ``--arch`` (qwen3-0.6b) at
full width (``--smoke``: its smoke config) cut to ``--layers`` layers,
fp32, batches of 4 x 128:

* ``loss`` — the mesh's loss and gradients against one device's (rank 0,
  no context) on the same weights and batch;
* ``zero`` — per-rank AdamW state bytes with the ZeRO layout the trainer
  gives, against the same moments laid out as their parameters, and one
  ZeRO step whose loss and global gradient norm hold to one device's (rank
  0, no context) on the same weights and batch;
* ``elastic`` — drop data replica 1: the survivors' loss on the batch
  trimmed to their replica count against one device's on the same rows;
  the dropped ranks leave the step loop.

Rank 0 prints one JSON line per check (with the card's name and power
limit on the card) and the run exits 1 when a check failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import ElasticRunner, initial_topology, reshard_batch
from repro_torch.distributed.sharding import (
    ShardingContext,
    activate,
    current_context,
    distribute_params,
    full_tensor,
)
from repro_torch.launch.mesh import make_local_mesh, start_world
from repro_torch.models.api import get_model
from repro_torch.train import Trainer
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.trainer import trainable, value_and_grad

LOSS_RTOL = 1e-5  # mesh vs one device, fp32 (the CPU tests' tolerance)
GRAD_TOL = 1e-4  # of the largest gradient entry
TP = 2  # the model axis
ROWS, SEQ = 4, 128  # a batch


def _local_bytes(tree) -> int:
    n = 0
    for v in tree.values():
        if isinstance(v, dict):
            n += _local_bytes(v)
        else:
            t = v.to_local() if isinstance(v, DTensor) else v
            n += t.numel() * t.element_size()
    return n


def _batch(cfg, rows, seed, device):
    rng = np.random.default_rng(seed)
    shape = (rows, SEQ)
    return {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, shape)).to(device),
            "targets": torch.from_numpy(rng.integers(1, cfg.vocab_size, shape)).to(device),
            "loss_mask": torch.ones(shape, device=device)}


def _model(cfg, device):
    return get_model(cfg, device=device).init(torch.Generator(device=device).manual_seed(0))


def check_loss(cfg, ctx, device):
    batch = _batch(cfg, ROWS, 1, device)
    single = None
    if dist.get_rank() == 0:
        model = _model(cfg, device)
        loss, _, grads = value_and_grad(model, trainable(model), batch)
        single = (float(loss), {k: g.float() for k, g in grads.items()})
        del model, grads
    model = _model(cfg, device)
    t = time.perf_counter()
    with activate(ctx):
        distribute_params(model, ctx)
        loss, _, grads = value_and_grad(
            model, trainable(model),
            {k: ctx.distribute(v, ("batch", None)) for k, v in batch.items()})
        loss = float(full_tensor(loss))
        full = {k: full_tensor(g.redistribute(g.device_mesh, model.get_parameter(k).placements))
                for k, g in grads.items()}
    step_s = time.perf_counter() - t
    if single is None:
        return None
    scale = max(float(g.abs().max()) for g in single[1].values())
    worst = max(float((full[k].float() - g).abs().max()) for k, g in single[1].items())
    return {"loss_mesh": loss, "loss_single": single[0],
            "loss_rel_err": abs(loss - single[0]) / abs(single[0]),
            "grad_err_of_scale": worst / scale, "mesh_step_s": step_s,
            "ok": abs(loss - single[0]) <= LOSS_RTOL * abs(single[0]) and worst <= GRAD_TOL * scale}


def check_zero(cfg, ctx, device):
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    batch = {k: v.cpu() for k, v in _batch(cfg, ROWS, 2, device).items()}
    single = None
    if dist.get_rank() == 0:
        single = Trainer(_model(cfg, device), tc).train(iter([batch]), 1, log_every=1)[0]
        if device.type == "cuda":
            torch.cuda.empty_cache()
    model = _model(cfg, device)
    with activate(ctx):
        tr = Trainer(model, tc)
        on = _local_bytes(tr.opt_state)
        off_state = adamw_init({k: full_tensor(p.detach()) for k, p in tr.params.items()})
        off = _local_bytes({part: {k: distribute_tensor(t, tr.params[k].device_mesh,
                                                        tr.params[k].placements,
                                                        src_data_rank=None)
                                   for k, t in tree.items()}
                            for part, tree in off_state.items()})
        del off_state
        step = tr.train(iter([batch]), 1, log_every=1)[0]
    if single is None:
        return None
    params = sum(p.numel() for p in tr.params.values())
    close = {k: abs(step[k] - single[k]) <= LOSS_RTOL * abs(single[k])
             for k in ("loss", "grad_norm")}
    return {"params": params, "adamw_bytes_per_rank_zero": on,
            "adamw_bytes_per_rank_no_zero": off, "ratio": off / on,
            "adamw_bytes_unsharded": 8 * params, "step_loss": step["loss"],
            "step_loss_single": single["loss"], "grad_norm_mesh": step["grad_norm"],
            "grad_norm_single": single["grad_norm"],
            "grad_norm_rel_err": abs(step["grad_norm"] - single["grad_norm"]) / single["grad_norm"],
            "ok": on < off and all(close.values())}


def check_elastic(cfg, device):
    state = {k: v.detach().clone() for k, v in _model(cfg, device).state_dict().items()}

    def factory(cfg_, mesh):
        model = get_model(cfg_, device=device)
        model.load_state_dict(state)
        distribute_params(model, current_context())
        return lambda b: model.loss(b)[0]

    runner = ElasticRunner(cfg, factory, initial_topology(model_axis=TP))
    data0 = runner.topo.data
    rows = 2 * data0 - 1  # trimmed to an even split on both meshes
    batch = {k: v.cpu() for k, v in _batch(cfg, rows, 3, device).items()}
    l0 = float(full_tensor(runner.run(reshard_batch(batch, runner.topo))))
    runner.on_failure(replica=data0 - 1)
    out = {"data": [data0, runner.topo.data], "member": runner.member,
           "rows": [rows // data0 * data0, rows // runner.topo.data * runner.topo.data]}
    if runner.member:
        out["losses_mesh"] = [l0, float(full_tensor(runner.run(reshard_batch(batch, runner.topo))))]
        out["events"] = runner.relower_events
    if dist.get_rank() != 0:
        return None
    model = get_model(cfg, device=device)
    model.load_state_dict(state)
    with torch.no_grad():
        single = [float(model.loss({k: v[:n].to(device) for k, v in batch.items()})[0])
                  for n in out["rows"]]
    out["losses_single"] = single
    out["ok"] = (len(out["events"]) == 2 and all(
        abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(out["losses_mesh"], single)))
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default: the cards) or cpu")
    args = ap.parse_args(argv)

    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity
        torch.backends.cudnn.allow_tf32 = False
    dev, owned = start_world(resolve_device(args.device))
    base = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = base.replace(num_layers=args.layers, param_dtype="float32",
                       activation_dtype="float32")
    ctx = ShardingContext.for_arch(cfg, make_local_mesh(TP))
    rank = dist.get_rank()
    card = card_line() if dev.type == "cuda" else "cpu"
    failed = False
    try:
        for name, fn in (("loss", lambda: check_loss(cfg, ctx, dev)),
                         ("zero", lambda: check_zero(cfg, ctx, dev)),
                         ("elastic", lambda: check_elastic(cfg, dev))):
            t = time.perf_counter()
            res = fn()
            if rank == 0:
                failed |= not res["ok"]
                print(json.dumps({"mesh_check": name, "model": cfg.name, "layers": cfg.num_layers,
                                  "mesh": [dist.get_world_size() // TP, TP],
                                  "seconds": time.perf_counter() - t, "card": card, **res}),
                      flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if owned:
            dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
