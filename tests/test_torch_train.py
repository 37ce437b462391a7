"""The port's training loop against the JAX package's, on the CPU at the
smoke size (fp32): the trainer's trajectories from the same weights, the
synthetic data pipeline, the checkpoint store, ``launch.train`` and the
``train_mini`` example.

* Trajectories: the reference's ``Trainer`` and the port's, 5 steps from
  the same weights on the same batches, for (adamw, accum 1), (adafactor,
  accum 2) and (adamw, int8 compression): the same steps logged, losses
  within rel 1e-4.
* Data: ``batch_at`` bitwise the reference's, a vlm's ``patch_embeds`` and
  an encoder-decoder's ``frames`` included; ``make_batches`` from
  ``start_step``, with and without prefetch.
* Checkpoints: the reference's atomicity, rotation and fingerprint test; a
  bitwise round trip with bfloat16 leaves (parameters and Adafactor's first
  moment); 3 steps, a checkpoint and 2 resumed steps against 5 in one run,
  within the reference's own 2e-5.
* ``launch.train`` run twice on one checkpoint directory; ``train_mini``
  with its ``MINI`` config set to the qwen3 smoke config on both sides:
  the same lines and ``resumed at step``.  Their losses are not compared:
  each side draws its own random weights.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.data import make_batches as ref_make_batches  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.train import Trainer as RefTrainer  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokens, make_batches  # noqa: E402
from repro_torch.examples import train_mini  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.optimizer import adafactor_init  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "qwen3-0.6b"
CFG = get_smoke_config(ARCH)


def _model(seed=0, cfg=CFG):
    return get_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer,accum,compression", [
    ("adamw", 1, "none"), ("adafactor", 2, "none"), ("adamw", 1, "int8")])
def test_trajectory_matches_reference(optimizer, accum, compression):
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5, optimizer=optimizer,
              grad_accum=accum, grad_compression=compression)
    state = dict(_model(7).named_parameters())
    tree = params_to_reference(state, CFG)
    ref_model = ref_get_model(ref_smoke(ARCH))
    ref = RefTrainer(ref_model, RefTrainConfig(**kw), params=jax.tree.map(jnp.asarray, tree))
    want = ref.train(ref_make_batches(RefTokens(ref_model.cfg, batch=4, seq_len=16, seed=3),
                                      prefetch=False), 5, log_every=2)
    port = Trainer(get_model(CFG, device="cpu"), TrainConfig(**kw),
                   params=params_from_reference(tree, CFG))
    got = port.train(make_batches(SyntheticTokens(CFG, batch=4, seq_len=16, seed=3),
                                  prefetch=False), 5, log_every=2)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 4]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"]), (g, w)
        assert abs(g["lr"] - w["lr"]) <= 1e-6 * max(w["lr"], 1e-30)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-3 * w["grad_norm"]
    assert got[-1]["loss"] < got[0]["loss"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-1b", "seamless-m4t-medium"])
def test_batch_at_bitwise(arch):
    want = RefTokens(ref_smoke(arch), batch=3, seq_len=48, seed=5).batch_at(7)
    got = SyntheticTokens(get_smoke_config(arch), batch=3, seq_len=48, seed=5).batch_at(7)
    extra = {"internvl2-1b": "patch_embeds", "seamless-m4t-medium": "frames"}.get(arch)
    assert extra is None or extra in want
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_make_batches_start_step_and_prefetch():
    src = SyntheticTokens(CFG, batch=2, seq_len=16, seed=4)
    plain = make_batches(src, start_step=5, prefetch=False)
    ahead = make_batches(src, start_step=5)
    for step in range(5, 9):
        a, b = next(plain), next(ahead)
        want = src.batch_at(step)
        for k in want:
            assert np.array_equal(a[k].numpy(), want[k]) and torch.equal(a[k], b[k])
    ahead.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_atomicity_and_rotation(tmp_path):
    params = dict(_model().named_parameters())
    opt = adafactor_init(params)
    ck = CheckpointManager(str(tmp_path), keep=2, fingerprint="x")
    for step in (10, 20, 30):
        ck.save(step, params, opt, extra={"k": step})
    assert ck.steps() == [20, 30]  # rotated
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp_")]
    manifest = json.loads((tmp_path / "step_00000030" / "MANIFEST.json").read_text())
    assert manifest == {"step": 30, "fingerprint": "x", "extra": {"k": 30}, "format": 1}
    restored = ck.restore_latest(params, opt)
    assert restored["step"] == 30 and restored["extra"] == {"k": 30}
    for k, p in params.items():
        assert torch.equal(restored["params"][k], p)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), fingerprint="other").restore(30, params, opt)


def test_checkpoint_round_trip_bf16_bitwise(tmp_path):
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16", activation_dtype="bfloat16")
    params = dict(_model(3, cfg).named_parameters())
    opt = adafactor_init(params)
    rng = np.random.default_rng(0)
    for k, m in opt["m"].items():  # values with every bit of a bf16 in use
        m.copy_(torch.from_numpy(rng.standard_normal(m.shape).astype(np.float32)))
    ck = CheckpointManager(str(tmp_path), keep=1)
    ck.save(1, params, opt)
    raw = ck.restore(1)["opt_state"]
    assert raw[f"m\x1d{next(iter(params))}"].dtype == np.uint16  # the bit pattern
    back = ck.restore(1, params, opt)
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    dtypes = set()
    for k, p in params.items():
        got, m = back["params"][k], back["opt_state"]["m"][k]
        dtypes |= {got.dtype, m.dtype}
        assert got.dtype == p.dtype and torch.equal(bits(got), bits(p)), k
        assert m.dtype == torch.bfloat16 and torch.equal(bits(m), bits(opt["m"][k])), k
        v, want_v = back["opt_state"]["v"][k], opt["v"][k]
        if isinstance(want_v, dict):
            assert all(torch.equal(v[n], want_v[n]) for n in ("row", "col"))
        else:
            assert torch.equal(v, want_v)
    assert torch.bfloat16 in dtypes and torch.float32 in dtypes


def test_resume_exact(tmp_path):
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=5, checkpoint_every=3)
    src = SyntheticTokens(CFG, batch=4, seq_len=16, seed=0)
    ck = CheckpointManager(str(tmp_path), keep=2, fingerprint=CFG.name)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    t1 = Trainer(get_model(CFG, device="cpu"), tc, generator=gen(), ckpt_manager=ck)
    t1.train(make_batches(src, prefetch=False), 3, log_every=3)
    t2 = Trainer(get_model(CFG, device="cpu"), tc, generator=torch.Generator().manual_seed(9),
                 ckpt_manager=ck)
    assert t2.maybe_resume() and t2.step == 3
    t2.train(make_batches(src, start_step=3, prefetch=False), 2, log_every=5)
    t3 = Trainer(get_model(CFG, device="cpu"), tc, generator=gen())
    t3.train(make_batches(src, prefetch=False), 5, log_every=5)
    for k, p in t3.params.items():
        np.testing.assert_allclose(t2.params[k].detach().numpy(), p.detach().numpy(),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# launch.train and train_mini
# ---------------------------------------------------------------------------


def test_launch_train_resumes(tmp_path, capsys):
    # checkpoints at steps 4 and 8: the second run resumes from step 8 and
    # logs step 10 again (the history holds step 1 and every 10th)
    argv = ["--smoke", "--steps", "10", "--ckpt", str(tmp_path), "--device", "cpu",
            "--ckpt-every", "4"]
    assert launch_train.main(argv) == 0
    first = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [h["step"] for h in first] == [1, 10]
    assert launch_train.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[train] resumed from step 8"
    second = [json.loads(line) for line in lines[1:]]
    assert [h["step"] for h in second] == [10]
    # the resumed run's step is the first run's, bit for bit
    assert second[0]["loss"] == first[1]["loss"]
    assert second[0]["grad_norm"] == first[1]["grad_norm"]


def _lines_without_numbers(text):
    """The printed lines with the losses, norms and rates masked."""
    import re

    return [re.sub(r"(loss|gnorm|lr) \S+", r"\1 _", re.sub(r"loss \S+ -> \S+", "loss _", line))
            .replace("insufficient drop", "_").replace("(OK)", "(_)")
            for line in text.splitlines()]


def test_train_mini_matches_reference(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("ref_train_mini",
                                                  REPO / "examples" / "train_mini.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    args = ["--steps", "6", "--batch", "4", "--seq", "16"]
    monkeypatch.setattr(ref, "MINI", ref_smoke(ARCH))

    def jit_init_model(cfg):
        # the same init, compiled once instead of dispatched op by op
        # eagerly (the first eager init of the smoke model takes seconds)
        model = ref_get_model(cfg)
        model.init = jax.jit(model.init)
        return model

    monkeypatch.setattr(ref, "get_model", jit_init_model)
    monkeypatch.setattr(sys, "argv", ["train_mini.py", *args])
    ref.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(train_mini, "MINI", CFG)
    out = train_mini.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines_without_numbers(got) == _lines_without_numbers(want)
    # steps // 3 = 2 between checkpoints: the first half's 3 steps leave step 2
    assert "resumed at step 2" in want and out["resumed_at"] == 2
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert [h["step"] for h in out["history_resumed"]] == [3, 4, 5, 6]
