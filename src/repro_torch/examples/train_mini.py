"""Train a ~100M-parameter qwen3-family model for a few hundred steps on the
synthetic Markov pipeline, with atomic checkpoints and a mid-run restart,
the port of the JAX package's ``examples/train_mini.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_mini [--steps 300] [--device cpu]

Runs on the card unless ``--device cpu``; the weights are random, drawn
from a ``torch.Generator`` seeded ``--seed``.  Prints the reference's
lines: the model, the history of each half, ``resumed at step N`` (the last
checkpoint of the first half) and the verdict, ``OK`` when the last loss is
more than 1.0 below the first.  ``main`` returns the two histories and the
resumed step.
"""

import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ArchConfig, TrainConfig
from repro_torch.data import SyntheticTokens, make_batches
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.train import Trainer

# ~100M params: 12L x d512 x ffn2048, 32k vocab
MINI = ArchConfig(
    name="qwen3-mini-100m",
    family="dense",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    qk_norm=True,
    tie_embeddings=True,
    param_dtype="float32",
    activation_dtype="float32",
    remat_policy="none",
)


def _print_history(hist) -> None:
    for h in hist:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  lr {h['lr']:.2e}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = get_model(MINI, device=dev)
    print(f"model: {MINI.name}, {model.param_count() / 1e6:.1f}M params")
    tc = TrainConfig(
        learning_rate=6e-4, warmup_steps=args.steps // 10,
        total_steps=args.steps, grad_accum=2, checkpoint_every=args.steps // 3,
    )
    src = SyntheticTokens(MINI, batch=args.batch, seq_len=args.seq, seed=0)

    def generator():
        return torch.Generator(device=dev).manual_seed(args.seed)

    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2, fingerprint=MINI.name)
        trainer = Trainer(model, tc, generator=generator(), ckpt_manager=ck)
        half = args.steps // 2
        hist = trainer.train(make_batches(src), half, log_every=max(half // 6, 1))
        _print_history(hist)

        print("\n-- simulated restart: new Trainer resumes from checkpoint --\n")
        trainer2 = Trainer(model, tc, generator=generator(), ckpt_manager=ck)
        if not trainer2.maybe_resume():
            raise RuntimeError("the restarted Trainer found no checkpoint to resume from")
        resumed = trainer2.step
        print(f"resumed at step {resumed}")
        hist2 = trainer2.train(make_batches(src, start_step=trainer2.step),
                               args.steps - trainer2.step, log_every=max(half // 6, 1))
        _print_history(hist2)
        first, last = hist[0]["loss"], hist2[-1]["loss"]
        ok = last < first - 1
        print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
              f"({'OK' if ok else 'insufficient drop'})")
    return {"history": hist, "history_resumed": hist2, "resumed_at": resumed, "ok": ok}


if __name__ == "__main__":
    main()
