"""The port's NeoEngine on the moe and vlm families against the JAX
package's, at the smoke size (deepseek-moe-16b: one dense0 layer and three
moe layers, 8 experts top-2 plus a shared one; internvl2-1b: 16 patch
embeddings), weights carried over through ``models/bridge.py`` and the perf
model frozen (``ewma_alpha=0``), so the plans follow from the inputs alone.

Scenarios: deepseek serial and pipelined with the neo policy offloading to
the host; the vlm with image requests (``extras``) pipelined, and a mixed
batch in which text-only requests share a prefill with image requests (the
reference's zero patch rows); the prefix cache on, deepseek (its suffix
prefills change a moe layer's capacity) and the vlm (image requests skip
the cache, text requests hit it); n-gram speculation on deepseek.  In every
one the port's tokens, plans and ``EngineStats`` counters, the terminal
states and the pages in use at the end equal the reference's.  Each
reference scenario runs once, in a module-scoped fixture.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.executor  # noqa: E402,F401  (its io_callback patch for one-core hosts)
from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

MOE, VLM = "deepseek-moe-16b", "internvl2-1b"
P = get_smoke_config(VLM).modality.num_embeds  # 16 patches at smoke size


@pytest.fixture(scope="module")
def weights():
    """arch -> (reference config, reference params, port state dict)."""
    out = {}
    for arch, seed in ((MOE, 3), (VLM, 4)):
        cfg_ref = ref_smoke(arch)
        params = ref_get_model(cfg_ref).init(jax.random.key(seed))
        out[arch] = (cfg_ref, params, params_from_reference(jax.tree.map(np.asarray, params),
                                                            get_smoke_config(arch)))
    return out


def _prompts(seed, sizes, base=0):
    """Seeded prompts, each opening with one shared ``base``-token prefix
    (the prefix cache's hits) when ``base`` is set."""
    rng = np.random.default_rng(seed)
    head = list(map(int, rng.integers(1, 500, size=base)))
    return [head + list(map(int, rng.integers(1, 500, size=n))) for n in sizes]


def _patches(seed, n):
    rng = np.random.default_rng(seed)
    return [{"patch_embeds": rng.normal(size=(P, 128)).astype(np.float32)} for _ in range(n)]


_OFFLOAD = dict(device_pool_pages=8, host_pool_pages=64, max_batch_tokens=256,
                policy="neo", planahead=False)
_SPEC = _prompts(21, (5, 9, 7))
_SPEC = [p[:4] * 4 + p for p in _SPEC]  # repetition the n-gram drafter can use
# name: (arch, engine options, waves of [(prompt, extras or None)], outputs).
# Waves run one after the other (the first seeds the prefix cache).
SCENARIOS = {
    "moe-serial": (MOE, dict(_OFFLOAD, pipeline=False),
                   [[(p, None) for p in _prompts(11, (30, 21, 37, 26, 18))]], 8),
    "moe-pipelined": (MOE, dict(_OFFLOAD, pipeline=True),
                      [[(p, None) for p in _prompts(11, (30, 21, 37, 26, 18))]], 8),
    "moe-pipelined-planahead": (MOE, dict(_OFFLOAD, pipeline=True, planahead=True),
                                [[(p, None) for p in _prompts(12, (23, 34, 29, 19))]], 6),
    "vlm-extras": (VLM, dict(_OFFLOAD, pipeline=True),
                   [list(zip(_prompts(13, (24, 40, 31, 20)), _patches(13, 4)))], 6),
    "vlm-mixed": (VLM, dict(_OFFLOAD, pipeline=True),
                  [[(p, e) for p, e in zip(_prompts(14, (28, 12, 35, 9)),
                                           [_patches(14, 1)[0], None, _patches(15, 1)[0],
                                            None])]], 6),
    "moe-prefix-cache": (MOE, dict(_OFFLOAD, pipeline=True, prefix_cache=True,
                                   device_pool_pages=16),
                         [[(p, None) for p in _prompts(16, (5,), base=24)],
                          [(p, None) for p in _prompts(16, (7, 3), base=24)]], 6),
    "moe-prefix-cache-off": (MOE, dict(_OFFLOAD, pipeline=True, device_pool_pages=16),
                             [[(p, None) for p in _prompts(16, (5,), base=24)],
                              [(p, None) for p in _prompts(16, (7, 3), base=24)]], 6),
    "vlm-prefix-cache": (VLM, dict(_OFFLOAD, pipeline=True, prefix_cache=True,
                                   device_pool_pages=16),
                         [[(p, None) for p in _prompts(18, (5,), base=24)],
                          list(zip(_prompts(18, (7, 3), base=24), [None, _patches(18, 1)[0]]))],
                         6),
    "moe-ngram-spec": (MOE, dict(_OFFLOAD, pipeline=True, policy="fastdecode",
                                 spec_decode=True, device_pool_pages=16),
                       [[(p, None) for p in _SPEC]], 8),
}


def _counters(stats):
    """Every ``EngineStats`` field that counts (ints, histograms, plans),
    and the lanes that ran; the wall-clock times, and the swap bytes whose
    copy window fell inside a dispatch window, are left out."""
    out = {}
    for name, v in vars(stats).items():
        if isinstance(v, float) or name == "swap_hidden_bytes":
            continue
        if name == "lane_busy_time":
            v = sorted(v)
        out[name] = v
    return out


def _run(side, weights, scenario):
    arch, opts, waves, n_out = SCENARIOS[scenario]
    cfg_ref, params, state = weights[arch]
    kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, **opts)
    if side == "ref":
        eng = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
    else:
        eng = NeoEngine(get_smoke_config(arch), EngineConfig(**kw), params=state, device="cpu")
    try:
        toks = {}
        for wave in waves:
            rids = [eng.submit(p, n_out, extras=e) for p, e in wave]
            done = eng.run_until_done(500)
            toks.update({r: done[r] for r in rids})
        cache = eng.prefix_cache
        return dict(tokens=toks, stats=_counters(eng.stats),
                    states={r: eng.requests[r].state.name for r in toks},
                    used=(eng.pool.device.used_pages, eng.pool.host.used_pages),
                    cache=None if cache is None else (cache.stats.lookups, cache.stats.hits,
                                                      cache.stats.hit_tokens))
    finally:
        eng.close()


@pytest.fixture(scope="module")
def runs(weights):
    return {name: {side: _run(side, weights, name) for side in ("ref", "port")}
            for name in SCENARIOS}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_reference(runs, scenario):
    ref, port = runs[scenario]["ref"], runs[scenario]["port"]
    assert port["tokens"] == ref["tokens"], scenario
    assert port["stats"] == ref["stats"], scenario
    assert port["states"] == ref["states"] and port["used"] == ref["used"]
    assert port["cache"] == ref["cache"]
    assert all(s == "FINISHED" for s in port["states"].values())
    st = port["stats"]
    if "cache" not in scenario and "spec" not in scenario:
        assert st["offloaded_decodes"] > 0, "the neo policy must offload"
    if scenario == "moe-ngram-spec":
        assert st["spec_steps"] > 0 and st["drafted_tokens"] > 0
    if scenario == "moe-prefix-cache":
        assert port["cache"][1] > 0, "the second wave must hit"
    if scenario == "vlm-prefix-cache":
        # the image request is never looked up: one lookup fewer than requests
        assert port["cache"][0] == 2 and port["cache"][1] == 1


def test_serial_equals_pipelined(runs):
    """The reference's claim, on the port: pipelining moves no token."""
    assert runs["moe-serial"]["port"]["tokens"] == runs["moe-pipelined"]["port"]["tokens"]


def test_prefix_cache_on_off_moe_record(runs):
    """Cache on = off on a moe model: a hit prefills only the suffix, at a
    smaller padded S, so a moe layer's capacity (and which slots drop)
    changes.  Whatever the reference does, the port does: both trees agree
    on whether the claim holds on this scenario (the record is in ROADMAP
    queue 3; the claim is not made)."""
    on, off = runs["moe-prefix-cache"], runs["moe-prefix-cache-off"]
    same = {side: on[side]["tokens"] == off[side]["tokens"] for side in ("ref", "port")}
    assert same["ref"] == same["port"], same
    print("moe prefix cache on = off:", same)


def test_extras_batch_zero_rows_match_reference():
    """The reference's ``_extras_batch``, which the mixed scenario runs: a
    request without the key gets a zero row, so a text-only request that
    shares a prefill with an image request sees zero patch embeddings at
    its first P positions (whenever the padded S reaches P); none of the
    requests with extras gives no extras."""
    from repro.core.request import Request as RefRequest
    from repro_torch.core.request import Request

    ex = _patches(19, 2)
    kinds = [ex[0], None, ex[1], None]
    ours = [Request(rid=i, prompt=[1], max_new_tokens=1, extras=e) for i, e in enumerate(kinds)]
    theirs = []
    for i, e in enumerate(kinds):
        r = RefRequest(rid=i, prompt=[1], max_new_tokens=1)
        if e:
            r.extras = e
        theirs.append(r)
    got = NeoEngine._extras_batch(ours, 32)
    want = RefEngine._extras_batch(theirs, 32)
    assert sorted(got) == sorted(want) == ["patch_embeds"]
    np.testing.assert_array_equal(got["patch_embeds"].numpy(), np.asarray(want["patch_embeds"]))
    assert not got["patch_embeds"][1].any() and not got["patch_embeds"][3].any()
    assert NeoEngine._extras_batch(ours[1::2], 32) == RefEngine._extras_batch(theirs[1::2], 32) == {}
