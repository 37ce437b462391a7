"""The port's paged decode attention against the JAX package's.

On the CPU the wrapper runs the plain version, which must match the
reference oracle ``paged_decode_ref`` over the reference sweep of
``tests/test_kernels.py`` (fp32 to 1e-5: the same algorithm with another
summation order; bf16 to 2e-2) and the Pallas kernel in interpret mode.  The
CUDA kernel itself runs only on the card: its tests are in
``test_torch_paged_decode_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_decode import ops  # noqa: E402
from repro_torch.kernels.paged_decode.ref import paged_decode_ref  # noqa: E402

SWEEP = [  # (B, H, KV, hd, page, npages): test_paged_decode_sweep's cases
    (1, 4, 4, 32, 8, 4),      # MHA
    (3, 8, 2, 32, 16, 4),     # GQA 4:1
    (2, 16, 8, 64, 16, 8),    # GQA 2:1, bigger head
    (2, 4, 1, 128, 8, 4),     # MQA, aligned head_dim
    (1, 14, 2, 112, 16, 4),   # odd heads + head_dim
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    from repro.kernels.paged_decode.ops import paged_decode_attention

    return jax, paged_decode_attention


def _inputs(seed, B, H, KV, hd, page, npages, lens=None):
    rng = np.random.default_rng(seed)
    P = npages * 4
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, page, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, hd)).astype(np.float32)
    bt = rng.integers(0, P, size=(B, npages)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, npages * page + 1, size=(B,))
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _port(arrs, dtype, device="cpu"):
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(device) for a in arrs)
    dt = getattr(torch, dtype)
    return q.to(dt), kp.to(dt), vp.to(dt), bt, lens


def _reference(jax_ref, arrs, dtype, impl="ref"):
    jax, fn = jax_ref
    jnp = jax.numpy
    q, kp, vp, bt, lens = arrs
    dt = getattr(jnp, dtype)
    out = fn(jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
             jnp.asarray(bt), jnp.asarray(lens), impl=impl, interpret=True)
    return np.asarray(out, np.float32)


def _edge_lens_cases():
    cases = [(f"sweep{i}", s, None) for i, s in enumerate(SWEEP)]
    cases.append(("len_edge", (3, 4, 2, 32, 8, 3), [1, 8, 24]))  # test_paged_decode_len_edge
    cases.append(("lens0", (3, 8, 2, 32, 16, 4), [0, 5, 0]))
    return cases


@pytest.mark.parametrize("name,shape,lens", _edge_lens_cases(),
                         ids=[c[0] for c in _edge_lens_cases()])
def test_plain_matches_reference_oracle(name, shape, lens, jax_ref):
    arrs = _inputs(sum(map(ord, name)), *shape, lens=lens)
    zero = np.asarray(arrs[4]) == 0
    for dtype in ("float32", "bfloat16"):
        want = _reference(jax_ref, arrs, dtype)
        got = ops.paged_decode_attention(*_port(arrs, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=dtype)
        assert not got.float().numpy()[zero].any()  # lens == 0 rows are zeros


def test_plain_matches_pallas_interpret(jax_ref):
    arrs = _inputs(11, 1, 14, 2, 112, 16, 4)
    want = _reference(jax_ref, arrs, "float32", impl="pallas")
    got = paged_decode_ref(*_port(arrs, "float32"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_wrapper_cpu_goes_to_plain_version():
    arrs = _inputs(3, 2, 8, 2, 64, 16, 4)
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(*_port(arrs, "float32"))
    want = paged_decode_ref(*_port(arrs, "float32"))
    assert torch.equal(got, want)
    assert ops.paged_decode_attention.launches == before  # no kernel launch


def test_wrapper_rejects_bad_inputs():
    q, kp, vp, bt, lens = _port(_inputs(4, 2, 4, 2, 32, 8, 4), "float32")
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q.half(), kp.half(), vp.half(), bt, lens)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kp, vp, bt.long(), lens)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                                   kp, vp, bt, lens)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, kp.to("meta"), vp, bt, lens)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, kp, vp, bt[:1], lens)


@pytest.mark.parametrize("dtype,hd,offset,ok", [
    ("bfloat16", 128, 0, True),
    ("bfloat16", 112, 0, True),    # 224-byte rows: whole 16-byte loads
    ("float32", 36, 0, True),      # 144-byte rows
    ("bfloat16", 36, 0, False),    # 72-byte rows
    ("float32", 30, 0, False),     # 120-byte rows
    ("bfloat16", 128, 4, False),   # pages start 8 bytes off a 16-byte boundary
    ("float32", 288, 0, False),    # head_dim past 256
])
def test_kernel_limits(dtype, hd, offset, ok):
    """What the CUDA kernel takes as it is: rows of whole 16-byte loads on
    16-byte aligned pages; anything else is refused before a launch."""
    dt = getattr(torch, dtype)
    q = torch.zeros(2, 4, hd, dtype=dt)
    flat = torch.zeros(offset + 3 * 8 * 2 * hd, dtype=dt)
    kp = flat[offset:].view(3, 8, 2, hd)
    assert kp.data_ptr() % 16 == (offset * kp.element_size()) % 16
    if ok:
        ops.check_kernel_limits(q, kp, kp)
    else:
        with pytest.raises(ValueError):
            ops.check_kernel_limits(q, kp, kp)
