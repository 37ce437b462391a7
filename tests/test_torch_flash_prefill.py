"""The port's flash prefill attention against the JAX package's.

On the CPU the wrapper runs the plain version, which must match the
reference oracle ``flash_prefill_ref`` over the sweep of
``tests/test_kernels.py`` (causal and not, MQA, hd = 48, window 32; fp32 to
1e-5: the same algorithm with another summation order; bf16 to 2e-2), the
Pallas kernel in interpret mode there, and the oracle alone at ragged S,
where the Pallas kernel cannot run.  The CUDA kernel runs only on the card:
its test carries the ``cuda`` marker and skips here.  The models' prefill
through :func:`repro_torch.models.attention.prefill_attention` is held to
the reference logits in ``test_torch_model.py`` and
``test_torch_mamba2_zamba2.py``; here the route itself is checked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_prefill import ops  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402

SWEEP = [  # (B, S, H, KV, hd): test_flash_prefill_sweep's cases
    (1, 128, 4, 4, 32),
    (2, 256, 8, 2, 64),
    (1, 192, 4, 1, 48),  # non-pow2 seq + MQA + odd head_dim
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_prefill.ops import flash_prefill
    from repro.kernels.flash_prefill.ref import flash_prefill_ref as oracle

    return jax, flash_prefill, oracle


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, n, hd)).astype(np.float32) for n in (H, KV, KV))


def _port(arrs, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(a).to(device).to(dt) for a in arrs)


def _oracle(jax_ref, arrs, dtype, causal, window):
    jax, _, oracle = jax_ref
    jnp = jax.numpy
    dt = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(a, dt) for a in arrs)
    return np.asarray(oracle(q, k, v, causal=causal, window=window), np.float32)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_oracle_and_pallas(shape, causal, jax_ref):
    arrs = _inputs(sum(shape) + causal, *shape)
    for dtype in ("float32", "bfloat16"):
        want = _oracle(jax_ref, arrs, dtype, causal, 0)
        got = ops.flash_prefill(*_port(arrs, dtype), causal=causal)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=dtype)
    _, fn, _ = jax_ref
    jnp = jax_ref[0].numpy
    pal = fn(*(jnp.asarray(a) for a in arrs), causal=causal, impl="pallas",
             interpret=True, blk_q=64, blk_k=64)
    got = flash_prefill_ref(*_port(arrs, "float32"), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=TOL["float32"],
                               atol=TOL["float32"])


def test_plain_matches_pallas_with_window(jax_ref):
    jax, fn, _ = jax_ref
    arrs = _inputs(32, 1, 128, 4, 4, 32)
    pal = fn(*(jax.numpy.asarray(a) for a in arrs), causal=True, window=32,
             impl="pallas", interpret=True, blk_q=32, blk_k=32)
    for dtype in ("float32", "bfloat16"):
        want = _oracle(jax_ref, arrs, dtype, True, 32)
        got = ops.flash_prefill(*_port(arrs, dtype), causal=True, window=32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=dtype)
    got = ops.flash_prefill(*_port(arrs, "float32"), causal=True, window=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [100, 130, 200])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
def test_ragged_lengths_match_oracle(S, causal, window, jax_ref):
    """Lengths that are no multiple of a tile (the port's padded prefill
    batches are as long as their longest prompt)."""
    arrs = _inputs(S + window, 2, S, 8, 2, 64)
    for dtype in ("float32", "bfloat16"):
        want = _oracle(jax_ref, arrs, dtype, causal, window)
        got = ops.flash_prefill(*_port(arrs, dtype), causal=causal, window=window)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=dtype)


def test_prefill_attention_routes():
    """``impl="kernel"`` is the wrapper (its plain version on the CPU, no
    launch counted), ``impl="plain"`` the chunked plain attention; both
    compute the same function."""
    q, k, v = _port(_inputs(7, 2, 70, 4, 2, 32), "float32")
    before = ops.flash_prefill.launches
    got = attn_lib.prefill_attention(q, k, v, causal=True, window=16)
    assert torch.equal(got, flash_prefill_ref(q, k, v, causal=True, window=16))
    assert ops.flash_prefill.launches == before
    plain = attn_lib.prefill_attention(q, k, v, causal=True, window=16, impl="plain")
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        attn_lib.prefill_attention(q, k, v, impl="pallas")


def test_wrapper_rejects_bad_inputs():
    q, k, v = _port(_inputs(4, 1, 16, 4, 2, 32), "float32")
    with pytest.raises(TypeError):
        ops.flash_prefill(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ops.flash_prefill(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        ops.flash_prefill(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        ops.flash_prefill(q, k[:, :8].contiguous(), v[:, :8].contiguous())
    with pytest.raises(ValueError):
        ops.flash_prefill(q[:, :, :3].contiguous(), k, v)  # 3 heads over 2 kv heads


@pytest.mark.parametrize("dtype,hd,offset,ok", [
    ("bfloat16", 128, 0, True),
    ("bfloat16", 112, 0, True),    # 224-byte rows: whole 16-byte loads
    ("float32", 36, 0, True),      # 144-byte rows
    ("float32", 256, 0, True),     # the largest head_dim, in fp32
    ("bfloat16", 36, 0, False),    # 72-byte rows
    ("float32", 30, 0, False),     # 120-byte rows
    ("bfloat16", 128, 4, False),   # 8 bytes off a 16-byte boundary
    ("bfloat16", 264, 0, False),   # head_dim past 256
    ("bfloat16", 32, 0, True),     # bf16 tensor-core kernel: hd % 16 == 0
    ("bfloat16", 48, 0, True),
    ("bfloat16", 64, 0, True),
    ("bfloat16", 256, 0, True),    # 4 chunks, 2 stages: 197,760 bytes
    ("bfloat16", 40, 0, False),    # whole 16-byte rows, but no wgmma k-depth
    ("bfloat16", 120, 0, False),
    ("float32", 40, 0, True),      # the fp32 kernel takes it (no k-depth rule)
])
def test_kernel_limits(dtype, hd, offset, ok):
    """What the CUDA kernels take as they are: rows of whole 16-byte loads,
    16-byte aligned tensors, head_dim <= 256, for bf16 (the tensor-core
    kernel) head_dim a multiple of 16, and each kernel's shared memory
    within the card's opt-in limit; anything else is refused before a
    launch."""
    dt = getattr(torch, dtype)
    flat = torch.zeros(offset + 2 * 5 * 4 * hd, dtype=dt)
    q = flat[offset:].view(2, 5, 4, hd)
    if ok:
        ops.check_kernel_limits(q, q, q)
        assert ops.smem_bytes(hd, dt) <= ops.MAX_SMEM
    else:
        with pytest.raises(ValueError):
            ops.check_kernel_limits(q, q, q)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 128, 4, 4, 32), True, 0), ((2, 256, 8, 2, 64), False, 0),
    ((1, 192, 4, 1, 48), True, 0), ((1, 128, 4, 4, 32), True, 32),
    ((2, 100, 8, 2, 64), True, 0), ((1, 130, 4, 2, 64), False, 0),
    ((1, 200, 8, 8, 112), True, 32), ((1, 512, 16, 8, 128), True, 0),
])
def test_cuda_kernel_matches_plain(shape, causal, window, cuda):
    arrs = _inputs(sum(shape), *shape)
    for dtype, tol in (("float32", 2e-3), ("bfloat16", 2e-2)):
        args = _port(arrs, dtype, device=cuda)
        before = ops.flash_prefill.launches
        got = ops.flash_prefill(*args, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.flash_prefill.launches == before + 1
        want = flash_prefill_ref(*args, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_smem_follows_the_kernel_of_each_dtype():
    """bf16 blocks hold both warpgroups' query tiles and a K/V ring of 64-dim
    chunks (3 stages up to hd = 128, 2 beyond); fp32 blocks the CUDA-core
    kernel's padded tiles and probabilities."""
    for hd, nch, stages in ((32, 1, 3), (112, 2, 3), (128, 2, 3), (192, 3, 2), (256, 4, 2)):
        assert ops.smem_bytes(hd, torch.bfloat16) == (1024 + (2 + 2 * stages) * nch * 8192
                                                      + 128)
        assert ops.smem_bytes(hd, torch.bfloat16) <= ops.MAX_SMEM
    assert ops.smem_bytes(128, torch.float32) == 3 * 64 * 129 * 4 + 64 * 65 * 4


TC_HEADS = {1: (4, 4), 2: (8, 4), 7: (14, 2)}  # qpk -> (H, KV)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 48, 64, 112, 128])
@pytest.mark.parametrize("qpk", [1, 2, 7])
def test_cuda_bf16_tensor_core_sweep(hd, qpk, cuda):
    """The bf16 tensor-core kernel against its plain version (2e-2) at every
    head_dim it is built for and groups of 1 (two 64-row tiles of one head
    per block), 2 (two heads per block) and 7 (a lone head in the last
    pair), over ragged S, causal and not, and a window."""
    H, KV = TC_HEADS[qpk]
    for i, (B, S, causal, window) in enumerate([(2, 100, True, 0), (1, 200, False, 0),
                                                 (1, 257, True, 48), (1, 64, True, 0)]):
        arrs = _inputs(1000 * hd + 10 * qpk + i, B, S, H, KV, hd)
        args = _port(arrs, "bfloat16", device=cuda)
        before = ops.flash_prefill.launches
        got = ops.flash_prefill(*args, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.flash_prefill.launches == before + 1
        want = flash_prefill_ref(*args, causal=causal, window=window)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_bf16_refuses_what_the_tensor_cores_cannot_take(cuda):
    """No fallback: a bf16 head_dim off wgmma's k-depth raises on the card
    (nothing runs the plain version or the fp32 kernel instead)."""
    q, k, v = _port(_inputs(3, 1, 64, 4, 2, 40), "bfloat16", device=cuda)
    before = ops.flash_prefill.launches
    with pytest.raises(ValueError):
        ops.flash_prefill(q, k, v)
    assert ops.flash_prefill.launches == before
