"""Training launcher of the port, on one device or on a data x model mesh.

Trains a model of ``--arch`` (``--smoke`` for its reduced config) on the
synthetic Markov token stream, with atomic checkpoints under ``--ckpt``:
kill it mid-run and launch it again to resume from the last checkpoint.
Runs on the card unless ``--device cpu``; prints the history as JSON lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
      --device cpu --steps 200 --batch 8 --seq 64 --ckpt /tmp/neo_ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --steps 30 \\
      --batch 8 --seq 512

Flags are the JAX launcher's, plus ``--device`` and ``--tp``.  The history
holds step 1 and every 10th step, as the reference's.

``--mesh`` trains on a data x model mesh of ``--tp`` model ranks over the
world that ``torch.distributed.run`` starts (one process per rank; it sets
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``): ``nccl`` with one card per
local rank, or ``gloo`` with ``--device cpu``, every collective under
``launch.mesh.COLLECTIVE_TIMEOUT_S``.  Every rank draws the same weights
and batches from the seed; each keeps its blocks
(``ShardingContext.for_arch(cfg, make_local_mesh(tp))``), and rank 0 alone
prints.  Without a launcher (or in a world of one) ``--mesh`` is the no-op
the reference's is on one device.

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-0.6b --mesh --tp 2 --steps 30 --seq 512
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.data import SyntheticTokens, make_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ShardingContext, activate
from repro_torch.launch.mesh import launched_world, make_local_mesh, start_world
from repro_torch.models.api import get_model
from repro_torch.train import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", action="store_true",
                    help="a data x model mesh over the launcher's ranks (a no-op without one)")
    ap.add_argument("--tp", type=int, default=None, help="model-axis size of --mesh (1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ctx, owned = None, False
    if args.mesh and launched_world() > 1:
        dev, owned = start_world(dev)
        ctx = ShardingContext.for_arch(cfg, make_local_mesh(args.tp))
    rank = dist.get_rank() if ctx is not None else 0
    try:
        with activate(ctx):
            hist, resumed = _train(args, cfg, dev)
    finally:
        if owned:
            dist.destroy_process_group()
    if rank == 0:
        if resumed:
            print(f"[train] resumed from step {resumed}")
        for h in hist:
            print(json.dumps(h))
    return 0


def _train(args, cfg, dev):
    """(the history, the step resumed from or 0) of the run ``args`` asks
    for, under the active context."""
    model = get_model(cfg, device=dev)
    tc = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        optimizer=args.optimizer,
        grad_accum=args.grad_accum,
        grad_compression=args.grad_compression,
        checkpoint_every=args.ckpt_every,
    )
    ckpt = CheckpointManager(args.ckpt, keep=2, fingerprint=cfg.name) if args.ckpt else None
    trainer = Trainer(model, tc, generator=torch.Generator(device=dev).manual_seed(args.seed),
                      ckpt_manager=ckpt)
    resumed = trainer.step if trainer.maybe_resume() else 0
    src = SyntheticTokens(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed)
    batches = make_batches(src, start_step=trainer.step)
    hist = trainer.train(batches, args.steps - trainer.step, log_every=10)
    batches.close()
    return hist, resumed


if __name__ == "__main__":
    raise SystemExit(main())
