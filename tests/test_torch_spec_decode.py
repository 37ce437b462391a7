"""The port's speculative decoding (``repro_torch.core.spec``,
``NeoEngine._run_spec_chain``) against the JAX package's, at the smoke size
(qwen3-0.6b: 4 layers, d_model 128, fp32), weights carried over through
``models/bridge.py`` and the perf model frozen (``ewma_alpha=0``), so the
plans, and with them each step's draft depth, follow from the inputs alone.

The scenarios are those of ``tests/test_spec_decode.py``: the n-gram
drafter on and off under ``fastdecode`` and ``neo`` (and once with
plan-ahead on), the forced accept and forced reject runs (a replay drafter
that proposes the serial continuation, a wrong drafter that proposes a token
that differs from it), rollback under recompute preemption, rollback over
prefix-cache pages shared between siblings, and greedy-only eligibility.  In
every one the port's tokens, every speculation counter, the accepted-length
histogram, the ``plans`` strings, plan-ahead's counters and the pages in use
at the end equal the reference's, and the port's tokens with speculation on
equal its own with speculation off.  Each reference scenario runs once, in a
module-scoped fixture.  The drafters themselves are held to the
reference's: ``NgramDrafter`` on seeded random token lists, and
``DraftModelDrafter`` on the bridged weights (logits 1e-4, equal argmax).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.executor  # noqa: E402,F401  (its io_callback patch for one-core hosts)
from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.core.spec import DraftModelDrafter as RefDraftModelDrafter  # noqa: E402
from repro.core.spec import NgramDrafter as RefNgramDrafter  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.spec import DraftModelDrafter, NgramDrafter  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

ARCH = "qwen3-0.6b"
CFG = get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def weights():
    """(reference config, reference params, port state dict)."""
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(7))
    return cfg_ref, params, params_from_reference(jax.tree.map(np.asarray, params), CFG)


class ReplayDrafter:
    """Proposes exactly the serial continuation (recorded from a run with
    speculation off): every draft is accepted."""

    def __init__(self, prompts, outs):
        self.table = {}
        for p, o in zip(prompts, outs):
            seq = list(p) + list(o)
            for t in range(len(o)):
                self.table[tuple(seq[:len(p) + t])] = list(o[t:])

    def propose(self, tokens, k):
        return self.table.get(tuple(tokens), [])[:k]


class WrongDrafter(ReplayDrafter):
    """Proposes one token that differs from the serial next token: every
    draft is rejected, so every verify pass rolls back."""

    def __init__(self, prompts, outs, vocab):
        super().__init__(prompts, outs)
        self.vocab = vocab

    def propose(self, tokens, k):
        cont = super().propose(tokens, k)
        return [(cont[0] + 1) % self.vocab] if cont else []


def _prompts(seed, sizes, repeat=0):
    """Seeded prompts; with ``repeat`` each opens with one 8-token base
    repeated that many times (repetition the n-gram drafter can use)."""
    rng = np.random.default_rng(seed)
    base = list(map(int, rng.integers(1, 500, size=8)))
    return [base * repeat + list(map(int, rng.integers(1, 500, size=n))) for n in sizes]


# name: (engine options, prompts, outputs, drafter ("ngram", "replay",
# "wrong"), waves).  Waves run one after the other (the first seeds the
# prefix cache); the engine options of the reference test, plus the frozen
# perf model and one hardware profile on both sides.
_POOLS = dict(device_pool_pages=8, host_pool_pages=128, max_batch_tokens=256, pipeline=True,
              microbatch=True, planahead=False)
_REPEAT = _prompts(11, (5, 9, 7), repeat=3)
_PLAIN = _prompts(12, (20, 33, 27))
_PREEMPT = _prompts(13, (22, 26, 24))
_SHARED = _prompts(14, (24,))[0]
_WAVES = [[_SHARED + [11]], [_SHARED + [13], _SHARED + [17]]]
SCENARIOS = {
    "ngram-fastdecode": (dict(_POOLS, policy="fastdecode"), [_REPEAT], 8, "ngram"),
    "ngram-neo": (dict(_POOLS, policy="neo"), [_REPEAT], 8, "ngram"),
    "ngram-fastdecode-planahead": (dict(_POOLS, policy="fastdecode", planahead=True),
                                   [_REPEAT], 8, "ngram"),
    "replay": (dict(_POOLS, policy="fastdecode"), [_PLAIN], 8, "replay"),
    "wrong": (dict(_POOLS, policy="fastdecode"), [_PLAIN], 8, "wrong"),
    "preempting-wrong": (dict(_POOLS, policy="fastdecode", host_pool_pages=6,
                              starvation_limit=2), [_PREEMPT], 10, "wrong"),
    "shared-prefix-wrong": (dict(_POOLS, policy="fastdecode", prefix_cache=True), _WAVES, 8,
                            "wrong"),
    "temperature": (dict(_POOLS, policy="fastdecode", decode_sample="temperature"),
                    [_prompts(15, (12,))], 8, "ngram"),
}
SPEC_FIELDS = ("spec_steps", "drafted_tokens", "accepted_tokens", "rejected_drafts",
               "accept_len_hist", "plans", "planahead_hits", "planahead_replans",
               "planahead_skipped", "tokens_out", "iterations")


def _drive(eng, waves, n_out):
    out = {}
    for wave in waves:
        rids = [eng.submit(p, n_out) for p in wave]
        done = eng.run_until_done(500)
        out.update({r: done[r] for r in rids})
    return out


def _run(side, weights, scenario, *, spec=True, serial_out=None):
    """One run: (tokens by rid, stats fields, terminal states, (device,
    host) pages in use at the end, prefix-cache hits)."""
    opts, waves, n_out, kind = SCENARIOS[scenario]
    cfg_ref, params, state = weights
    kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, spec_decode=spec, **opts)
    if side == "ref":
        eng = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
    else:
        eng = NeoEngine(CFG, EngineConfig(**kw), params=state, device="cpu")
    try:
        prompts = [p for wave in waves for p in wave]
        if spec and kind == "replay":
            eng.drafter = ReplayDrafter(prompts, serial_out)
        elif spec and kind == "wrong":
            eng.drafter = WrongDrafter(prompts, serial_out, CFG.vocab_size)
        toks = _drive(eng, waves, n_out)
        s = eng.stats
        stats = {f: getattr(s, f) for f in SPEC_FIELDS}
        return dict(tokens=toks, stats=stats,
                    states={r: eng.requests[r].state.name for r in toks},
                    used=(eng.pool.device.used_pages, eng.pool.host.used_pages),
                    hits=eng.prefix_cache.stats.hits if eng.prefix_cache is not None else 0)
    finally:
        eng.close()


@pytest.fixture(scope="module")
def runs(weights):
    """Per scenario: the port's run with speculation off, the port's and the
    reference's with it on (the replay and wrong drafters replay the port's
    speculation-off tokens; both sides get equal drafters)."""
    out = {}
    for name, (_, waves, _, _) in SCENARIOS.items():
        off = _run("port", weights, name, spec=False)
        serial = [off["tokens"][r] for r in sorted(off["tokens"])]
        out[name] = {"off": off,
                     "ref": _run("ref", weights, name, serial_out=serial),
                     "port": _run("port", weights, name, serial_out=serial)}
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_spec_matches_reference(runs, scenario):
    r = runs[scenario]
    ref, port, off = r["ref"], r["port"], r["off"]
    assert port["tokens"] == ref["tokens"], scenario
    assert port["stats"] == ref["stats"], scenario
    assert port["used"] == ref["used"] and port["states"] == ref["states"]
    assert port["hits"] == ref["hits"]
    assert all(s == "FINISHED" for s in port["states"].values())
    if scenario != "temperature":
        # speculation moves no token, and rollback leaks no page
        assert port["tokens"] == off["tokens"], scenario
        assert port["used"] == off["used"], scenario
    st, st_off = port["stats"], off["stats"]
    assert st_off["spec_steps"] == st_off["drafted_tokens"] == 0
    assert st["rejected_drafts"] == st["drafted_tokens"] - st["accepted_tokens"]
    assert sum(k * v for k, v in st["accept_len_hist"].items()) == st["accepted_tokens"]
    if scenario == "temperature":
        # structural eligibility: no chain where acceptance cannot be exact
        assert st["spec_steps"] == st["drafted_tokens"] == 0
        return
    assert st["spec_steps"] > 0 and st["drafted_tokens"] > 0
    if scenario.startswith("ngram"):
        # the chain's emissions cut the iterations below serial decode's
        assert st["iterations"] < st_off["iterations"]
    if scenario == "replay":
        assert st["accepted_tokens"] == st["drafted_tokens"]
        assert any(k >= 1 for k in st["accept_len_hist"])
    if scenario.endswith("wrong"):
        assert st["accepted_tokens"] == 0 and set(st["accept_len_hist"]) == {0}
    if scenario == "preempting-wrong":
        preempts = sum(int(p.split("preempt=")[1].split()[0]) for p in st["plans"])
        assert preempts > 0, "the scenario must preempt"
    if scenario == "shared-prefix-wrong":
        assert port["hits"] > 0, "siblings must share cached prefix pages"
    if scenario == "ngram-fastdecode-planahead":
        # the chain emits after the planner cloned the shadow state: the
        # reference falsifies those speculations and replans, and so must
        # the port (equal counters, checked above)
        assert st["planahead_replans"] > 0 and st["planahead_hits"] + \
            st["planahead_replans"] + st["planahead_skipped"] > 0


# ---------------------------------------------------------------------------
# the drafters
# ---------------------------------------------------------------------------


def test_ngram_drafter_proposes_repeats():
    """The reference test's cases."""
    d = NgramDrafter(3)
    assert d.propose([4, 5, 6, 7, 8, 9, 1, 4, 5, 6], 3) == [7, 8, 9]
    assert d.propose([4, 5, 6, 7, 8, 9, 1, 4, 5, 6], 2) == [7, 8]
    assert d.propose([1, 2, 3, 4, 5, 6, 7], 4) == []
    assert d.propose([9, 1, 9, 2, 9], 2) == [2, 9]
    assert d.propose([], 4) == []
    assert d.propose([1, 2, 3], 0) == []


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ngram_drafter_matches_reference(n):
    rng = np.random.default_rng(100 + n)
    port, ref = NgramDrafter(n), RefNgramDrafter(n)
    proposed = 0
    for _ in range(200):
        toks = list(map(int, rng.integers(0, int(rng.integers(2, 12)),
                                          size=int(rng.integers(0, 40)))))
        for k in range(6):
            got = port.propose(toks, k)
            assert got == ref.propose(toks, k), (toks, k)
            proposed += bool(got)
    assert proposed > 0


@pytest.fixture(scope="module")
def draft_pair(weights):
    cfg_ref, params, state = weights
    model = get_model(CFG, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return ref_get_model(cfg_ref), params, model


def test_draft_model_drafter_matches_reference(draft_pair):
    """On the CPU (the flash prefill kernel's plain version) the port's
    drafter proposes the reference's tokens over the bridged weights; the
    logits of each window agree to 1e-4 with equal argmax."""
    ref_model, params, model = draft_pair
    port = DraftModelDrafter(model, vocab_size=CFG.vocab_size)
    ref = RefDraftModelDrafter(ref_model, params, vocab_size=CFG.vocab_size)
    assert port.window == ref.window == 64
    rng = np.random.default_rng(5)
    for n, k in ((70, 3), (12, 4), (40, 2)):
        toks = list(map(int, rng.integers(1, CFG.vocab_size, size=n)))
        got = port.propose(toks, k)
        assert got == ref.propose(toks, k) and len(got) == k
        win = toks[-port.window:]
        lp, _ = model.prefill(torch.tensor([win]), impl="kernel")
        lr, _ = ref_model.prefill(params, jax.numpy.asarray([win], dtype=jax.numpy.int32))
        lr = np.asarray(lr)
        np.testing.assert_allclose(lp.numpy(), lr, rtol=1e-4, atol=1e-4)
        assert int(lp[0].argmax()) == int(lr[0].argmax()) == got[0]
    assert port.prefills == 9


def test_draft_model_drafter_window_floor_vocab_check_and_purity(draft_pair):
    _, _, model = draft_pair
    assert DraftModelDrafter(model, window=3).window == 8
    toks = list(range(1, 30))
    free = DraftModelDrafter(model).propose(toks, 3)
    assert len(free) == 3
    # a proposed id outside the target's vocabulary stops the rollout
    assert DraftModelDrafter(model, vocab_size=free[0]).propose(toks, 3) == []
    assert DraftModelDrafter(model).propose(toks, 0) == []
    assert DraftModelDrafter(model).propose([], 3) == []
    assert toks == list(range(1, 30))  # the context is not mutated


def test_engine_serves_with_draft_model_drafter(weights):
    """The draft-model seam on the port's engine: greedy tokens equal
    speculation off; drafts are proposed, verified and counted, and the
    drafter touches no pool (its model is not the engine's)."""
    cfg_ref, params, state = weights
    runs = {}
    for spec in (False, True):
        eng = NeoEngine(CFG, EngineConfig(hw_profile="h100_sxm", ewma_alpha=0.0,
                                          spec_decode=spec, **dict(_POOLS, policy="neo")),
                        params=state, device="cpu")
        try:
            if spec:
                model = get_model(CFG, device="cpu")
                model.init(torch.Generator().manual_seed(1))
                eng.drafter = DraftModelDrafter(model, vocab_size=CFG.vocab_size)
            runs[spec] = (_drive(eng, [_REPEAT], 6), eng.stats, eng.drafter,
                          (eng.pool.device.used_pages, eng.pool.host.used_pages))
        finally:
            eng.close()
    assert runs[True][0] == runs[False][0] and runs[True][3] == runs[False][3]
    st, drafter = runs[True][1], runs[True][2]
    assert st.spec_steps > 0 and st.drafted_tokens > 0
    assert drafter.prefills >= st.drafted_tokens
