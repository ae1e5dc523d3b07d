"""The port's flash attention (plain version, and the wrapper on CPU
tensors) against the JAX package's ``flash_attention_ref`` and its Pallas
kernel in interpret mode, on identical numpy inputs; plus the LM slice's
own geometries (GQA 9 over 3, hd 64, a decode row at ``q_offset`` = its
position, Sk = the cache length). Tolerances: 2e-5 in float32 (summation
order), 2e-2 in bf16 (one rounding of the output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, sq, sk, h, kvh, hd, dtype):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd))]


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_port(seed, shape, causal, dtype, q_offset):
    q, k, v = _inputs(seed, *shape, dtype)
    want = jax_ref(*(_jax(x, dtype) for x in (q, k, v)), causal=causal,
                   q_offset=q_offset)
    args = [_torch(x, dtype) for x in (q, k, v)]
    plain = flash_attention_ref(*args, causal=causal, q_offset=q_offset)
    got = flash_attention(*args, causal=causal, q_offset=q_offset)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == tuple(q.shape)
    assert torch.equal(got, plain)  # a CPU tensor runs the plain version
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(plain), _np32(want), rtol=tol, atol=tol)


# the shape sweep of tests/test_flash_attention.py: (b, sq, sk, h, kvh, hd)
@pytest.mark.parametrize("shape", [
    (1, 128, 128, 4, 4, 32),
    (2, 256, 256, 8, 2, 16),     # GQA rep=4
    (1, 64, 512, 4, 1, 32),      # decode-ish, MQA
    (2, 512, 512, 6, 3, 64),     # odd head counts
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_ref(shape, causal, dtype):
    b, sq, sk = shape[:3]
    _check_port(sum(shape), shape, causal, dtype, sk - sq if causal else 0)


# the serving slice's geometries: smollm-135m's 9 heads over 3 KV heads at
# hd 64; prefill attends over the whole cache (Sk = max_len) from position
# 0, decode is one row at q_offset = its position; and lengths that no
# block size divides
@pytest.mark.parametrize("shape,q_offset", [
    ((2, 12, 20, 9, 3, 64), 0),      # prefill over a 20-slot cache
    ((2, 1, 20, 9, 3, 64), 13),      # decode at position 13
    ((4, 1, 40, 9, 3, 64), 39),      # decode at the last slot
    ((1, 5, 37, 6, 2, 128), 3),      # ragged Sq, Sk; hd 128
    ((3, 9, 9, 4, 4, 8), 0),         # Sq = Sk, no GQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_ref_at_the_slice_geometries(shape, q_offset, dtype):
    _check_port(sum(shape) + q_offset, shape, True, dtype, q_offset)


@pytest.mark.parametrize("shape,qb,kb,causal", [
    ((1, 64, 64, 4, 2, 16), 32, 32, True),
    ((2, 32, 96, 6, 3, 8), 16, 32, False),
])
def test_port_matches_pallas_kernel_in_interpret_mode(shape, qb, kb, causal):
    q, k, v = _inputs(7, *shape, "float32")
    off = shape[2] - shape[1] if causal else 0
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                     q_offset=off, qb=qb, kb=kb, interpret=True)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_wrapper_validates_and_cpu_never_launches():
    q = torch.zeros(1, 4, 6, 8)
    kv = torch.zeros(1, 4, 4, 8)  # 6 heads do not group over 4
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 5, 3, 8))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8),
                        q_offset=-1)
    reset_launches()
    flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    assert LAUNCHES["flash_attention"] == 0


@pytest.mark.gpu
def test_kernel_on_card_matches_plain_version():
    """The CUDA kernel against the plain version on the card: bf16 and
    float32, hd 64 and 128, prefill (8 rows a block), decode (splits over
    keys) and ragged lengths; other head dims and dtypes raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = [((2, 12, 20, 9, 3, 64), 0, True), ((4, 1, 2048, 9, 3, 64), 1999, True),
             ((2, 1, 40, 9, 3, 64), 39, True), ((1, 77, 300, 8, 2, 128), 5, True),
             ((2, 3, 513, 16, 2, 128), 510, True), ((2, 64, 64, 6, 3, 64), 0, False),
             ((1, 1, 1, 4, 1, 64), 0, True)]
    for shape, off, causal in cases:
        for dtype in ("bfloat16", "float32"):
            q, k, v = (_torch(x, dtype).to(dev)
                       for x in _inputs(sum(shape), *shape, dtype))
            reset_launches()
            got = flash_attention(q, k, v, causal=causal, q_offset=off)
            assert LAUNCHES["flash_attention"] == 1
            want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
    q = torch.zeros(1, 4, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
