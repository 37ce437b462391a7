"""The plain references against repro_torch's models on the same weights,
at smoke size on the CPU: a prefill's first-token logits, then each decode
step's, in float32 on both sides."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import pytest  # noqa: E402
import torch  # noqa: E402

from bench import harness, testing, weights  # noqa: E402
from bench.reference import moe as ref_moe  # noqa: E402
from repro_torch.testing import one_thread  # noqa: E402,F401

SEED = 2**31 + 11


def port_model(cfg):
    from repro_torch.config import ArchConfig, MoEConfig
    from repro_torch.models.transformer import DenseLM

    port = dict(cfg["port"])
    moe = port.pop("moe", None)
    arch = ArchConfig(**port, moe=MoEConfig(**moe) if moe else None)
    model = DenseLM(arch, device="cpu")
    ref = harness.reference(cfg["family"])
    model.load_state_dict(weights.make(ref.weight_groups(cfg), SEED, "cpu"), strict=True)
    return model, ref


def served_logits(model, prompt, served):
    """The port's prefill logits, then its decode logits over ``served``."""
    P = len(prompt)
    S = ref_moe.padded_len(P)
    tokens = torch.zeros((1, S), dtype=torch.long)
    tokens[0, :P] = torch.tensor(prompt)
    with torch.inference_mode():
        lg, cache = model.prefill(tokens, capacity=S + len(served),
                                  true_lens=torch.tensor([P]), impl="plain")
        out = [lg[0]]
        for t in served[:-1]:
            lg, cache = model.decode(torch.tensor([t]), cache)
            out.append(lg[0])
    return torch.stack(out).float()


@pytest.mark.parametrize("make", [testing.dense, testing.moe], ids=["dense", "moe"])
def test_reference_matches_port(make):
    cfg = make()
    model, ref = port_model(cfg)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, cfg["vocab_size"], (37,), generator=g).tolist()
    served = torch.randint(1, cfg["vocab_size"], (6,), generator=g).tolist()
    port = served_logits(model, prompt, served)
    w = weights.make(ref.weight_groups(cfg), SEED, "cpu")
    seq = {"tokens": torch.tensor(prompt + served[:-1]),
           "want": torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served)),
           "prompt_len": len(prompt), "batch_len": len(prompt)}
    (mine,) = ref.logits_at(w, cfg, [seq])
    torch.testing.assert_close(mine, port, rtol=1e-4, atol=1e-4)


def test_moe_reference_drops_over_capacity():
    """The smoke MoE's capacity binds on a 37-token row: the reference's
    keep mask drops slots there, and a wrong batch length moves logits."""
    cfg = testing.moe()
    w = weights.make(ref_moe.weight_groups(cfg), SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, cfg["vocab_size"], (37,), generator=g).tolist()
    seq = {"tokens": torch.tensor(prompt), "want": torch.tensor([36]),
           "prompt_len": 37, "batch_len": 37}
    a = ref_moe.logits_at(w, cfg, [seq])[0]
    b = ref_moe.logits_at(w, cfg, [dict(seq, batch_len=300)])[0]
    assert (a - b).abs().max() > 1e-3


def test_control_is_coarser_than_bf16():
    """The float8 control moves the logits far more than bfloat16 weights do."""
    cfg = testing.dense()
    ref = harness.reference("dense")
    w = weights.make(ref.weight_groups(cfg), SEED, "cpu")
    seq = {"tokens": torch.arange(1, 41), "want": torch.arange(40)}
    (base,) = ref.logits_at(w, cfg, [seq])
    (ctrl,) = ref.logits_at(w, cfg, [seq], quant="fp8")
    assert (ctrl - base).abs().max() > 5e-3
