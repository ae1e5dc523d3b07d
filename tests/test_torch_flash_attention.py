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
from repro_torch.kernels.flash_attention.ops import decode_splits

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


# the enc-dec and VLM slice: whisper's non-causal attention over 1,500
# frames (the encoder's self-attention, cut to 2 heads of 64 rows here, and
# the decoder's cross-attention of a few rows), 20 heads at hd 64 with
# Sk = 23 x 64 + 28; internvl2's GQA rep 6 at hd 128 (48 heads over 8, cut
# to 12 over 2) in prefill and decode over an 800-slot cache
@pytest.mark.parametrize("shape,q_offset,causal", [
    ((1, 64, 1500, 2, 2, 64), 0, False),
    ((2, 4, 1500, 20, 20, 64), 0, False),
    ((2, 1, 1500, 20, 20, 64), 0, False),
    ((1, 48, 800, 12, 2, 128), 0, True),
    ((2, 1, 800, 12, 2, 128), 790, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_ref_at_the_encdec_and_vlm_geometries(
        shape, q_offset, causal, dtype):
    _check_port(sum(shape) + q_offset, shape, causal, dtype, q_offset)


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
    float32, hd 64, 80, 112 and 128, prefill (8 rows a block), decode
    (splits over keys) and ragged lengths; other head dims and dtypes
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = [((2, 12, 20, 9, 3, 64), 0, True), ((4, 1, 2048, 9, 3, 64), 1999, True),
             ((2, 1, 40, 9, 3, 64), 39, True), ((1, 77, 300, 8, 2, 128), 5, True),
             ((2, 3, 513, 16, 2, 128), 510, True), ((2, 64, 64, 6, 3, 64), 0, False),
             ((1, 1, 1, 4, 1, 64), 0, True),
             # hd 80 and 112 (zamba2's shared attention, kimi-k2): prefill,
             # decode with one split and with several, rep 1 and 8, Sk not
             # a multiple of 64
             ((2, 12, 20, 4, 4, 80), 0, True), ((1, 77, 300, 8, 1, 80), 5, True),
             ((4, 1, 2048, 32, 32, 80), 1999, True),
             ((2, 3, 200, 8, 1, 80), 190, True), ((2, 1, 1000, 8, 1, 80), 900, True),
             ((2, 64, 64, 4, 2, 80), 0, False),
             ((2, 12, 20, 16, 2, 112), 0, True),
             ((1, 77, 300, 8, 1, 112), 5, True),
             ((2, 1, 2000, 64, 8, 112), 1999, True),
             ((2, 3, 513, 8, 8, 112), 510, True), ((2, 5, 200, 8, 1, 112), 190, True),
             ((2, 64, 64, 6, 3, 112), 0, False)]
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


# ------------------------------------------------ the kernel's new arithmetic
def _scores(q, k, causal, q_offset):
    """f32 scores [B, KV, rep, Sq, Sk] and the causal keep mask [Sq, Sk]."""
    b, sq, h, hd = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * hd ** -0.5
    pos = q_offset + torch.arange(sq)[:, None]
    keep = pos >= torch.arange(sk)[None, :] if causal else \
        torch.ones(sq, sk, dtype=torch.bool)
    return s.masked_fill(~keep, -1e30), keep


def _out(acc, l, q):
    b, sq, h, hd = q.shape
    o = acc / l.clamp_min(1e-30)[..., None]  # [B, KV, rep, Sq, hd]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def split_k_model(q, k, v, causal, q_offset, splits):
    """The split-K decode in plain float32: the keys up to the causal limit
    cut into ``splits`` runs; each run's (m, l, acc) per row (a row whose
    causal limit is before the run's first key keeps m = -inf, l = 0,
    acc = 0, as the kernel skips it), merged as m = max m_s,
    l = sum l_s e^(m_s - m), o = sum acc_s e^(m_s - m) / max(l, 1e-30)."""
    s, keep = _scores(q, k, causal, q_offset)
    sq, sk = keep.shape
    key_end = min(sk, q_offset + sq) if causal else sk
    run = -(-key_end // splits)
    parts = []
    for lo in range(0, key_end, run):
        hi = min(key_end, lo + run)
        ss = s[..., lo:hi]
        m = ss.amax(-1)
        p = torch.exp(ss - m[..., None])
        acc = torch.einsum("bgrqk,bkgd->bgrqd", p, v[:, lo:hi].float())
        seen = keep[:, lo]  # the run's first key: is any key of it seen
        m = torch.where(seen, m, -torch.inf)
        parts.append((m, torch.where(seen, p.sum(-1), 0.0),
                      torch.where(seen[:, None], acc, 0.0), seen))
    assert len(parts) == splits
    m = torch.stack([x[0] for x in parts]).amax(0)
    w = [torch.where(x[0] == -torch.inf, 0.0, torch.exp(x[0] - m))
         for x in parts]
    l = sum(x[1] * wi for x, wi in zip(parts, w))
    acc = sum(x[2] * wi[..., None] for x, wi in zip(parts, w))
    return _out(acc, l, q).to(q.dtype), [bool((~x[3]).any()) for x in parts]


def p_split_model(q, k, v, causal, q_offset, keep_lo=True, tile=64):
    """The tensor-core prefill's arithmetic in plain float32: the online
    softmax over 64-key tiles, with O += P_hi V + P_lo V where
    P_hi = bf16(P), P_lo = bf16(P - P_hi) (``keep_lo=False``: a single bf16
    P, which is not the kernel's function)."""
    s, _ = _scores(q, k, causal, q_offset)
    vf = v.float()
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], q.shape[-1])
    for lo in range(0, s.shape[-1], tile):
        ss = s[..., lo:lo + tile]
        m_new = torch.maximum(m, ss.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(ss - m_new[..., None])
        l = l * corr + p.sum(-1)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float() if keep_lo else 0.0 * p
        acc = acc * corr[..., None] + sum(
            torch.einsum("bgrqk,bkgd->bgrqd", pp, vf[:, lo:lo + tile])
            for pp in (p_hi, p_lo))
        m = m_new
    return _out(acc, l, q).to(q.dtype)


def _bf16_inputs(seed, shape):
    """Inputs a bf16 kernel sees, as float32 and as bf16 numpy copies."""
    xs = [torch.from_numpy(x).bfloat16() for x in _inputs(seed, *shape, None)]
    return [x.float() for x in xs], xs


# about one bf16 ulp: the card check's tolerance (chip_smoke.py phase 5)
BF16_ULP = dict(rtol=8e-3, atol=1e-3)


@pytest.mark.parametrize("splits", [1, 2, 7, 32])
def test_split_k_merge_matches_jax_ref(splits):
    """Five decode rows at positions 90-94 of a 100-slot cache (9 heads over
    3, hd 64): every split count gives the JAX reference's output, in f32
    within 1e-5 and in bf16 within about one ulp; with 32 splits the last
    holds only keys past the limit of the first rows."""
    shape, off = (2, 5, 100, 9, 3, 64), 90
    f32, b16 = _bf16_inputs(splits, shape)
    got, unseen = split_k_model(*f32, True, off, splits)
    want = jax_ref(*(jnp.asarray(x.numpy()) for x in f32), causal=True,
                   q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if splits == 32:
        assert unseen[-1] and not unseen[0]
    got16, _ = split_k_model(*b16, True, off, splits)
    want16 = jax_ref(*(_jax(x.float().numpy(), "bfloat16") for x in b16),
                     causal=True, q_offset=off)
    np.testing.assert_allclose(_np32(got16), _np32(want16), **BF16_ULP)


@pytest.mark.parametrize("shape,q_offset,causal", [
    ((2, 23, 150, 9, 3, 64), 0, True),       # prefill over a longer cache
    ((2, 23, 150, 9, 3, 64), 127, True),     # the last 23 positions
    ((1, 16, 70, 8, 1, 128), 54, True),      # rep 8, hd 128
    ((2, 40, 90, 4, 4, 64), 0, False),       # rep 1, no mask
])
def test_p_hi_lo_split_matches_jax_ref(shape, q_offset, causal):
    """P split into bf16 hi and lo parts through the P V product keeps the
    JAX kernel's float32 P: within 1e-5 of the JAX reference on bf16
    inputs held in f32 (a single bf16 P misses that by far), and within
    about one bf16 ulp in bf16."""
    f32, b16 = _bf16_inputs(sum(shape) + q_offset, shape)
    want = np.asarray(jax_ref(*(jnp.asarray(x.numpy()) for x in f32),
                              causal=causal, q_offset=q_offset))
    got = p_split_model(*f32, causal, q_offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    single = p_split_model(*f32, causal, q_offset, keep_lo=False).numpy()
    assert np.abs(single - want).max() > 1e-4
    got16 = p_split_model(*b16, causal, q_offset)
    want16 = jax_ref(*(_jax(x.float().numpy(), "bfloat16") for x in b16),
                     causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np32(got16), _np32(want16), **BF16_ULP)


@pytest.mark.parametrize("b,sq,sk,h,kvh,off,want", [
    (4, 1, 2048, 9, 3, 1920, 31),   # serving run b's first decode step
    (4, 1, 2048, 9, 3, 2046, 32),   # its last: 12 groups x 32 = 384 blocks
    (4, 1, 128, 9, 3, 20, 1),       # run a: a cache of 128
    (4, 1, 2048, 9, 3, 255, 1),     # 4 tiles: one block walks them
    (4, 1, 2048, 9, 3, 256, 5),     # 5 tiles: split
    (64, 1, 4096, 32, 8, 4095, 1),  # 512 groups: one split
    (2, 15, 4096, 32, 8, 4000, 9),  # 60 rows: 4 row blocks a group
])
def test_decode_splits_fill_the_card(b, sq, sk, h, kvh, off, want):
    """One split per 64-key tile up to the causal limit until the grid
    would pass ~512 blocks; then several tiles a split; none for a cache
    of at most 4 tiles."""
    splits = decode_splits(b, sq, sk, h, kvh, True, off)
    assert splits == want
    key_end = min(sk, off + sq)
    assert splits <= -(-key_end // 64)


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal,off,want", [
    (4, 1, 1500, 20, 20, False, 0, 8),   # whisper's cross-attention decode
    (4, 4, 1500, 20, 20, False, 0, 8),   # its prefill, a 4-token prompt
    (4, 4, 132, 20, 20, True, 0, 1),     # the decoder's self-attention
    (4, 1, 132, 20, 20, True, 130, 1),   # 3 tiles: one block walks them
    (4, 1, 800, 48, 8, True, 768, 13),   # internvl2's first decode step
    (4, 1, 800, 48, 8, True, 798, 13),   # its last: 13 tiles, 32 groups
])
def test_decode_splits_at_the_encdec_and_vlm_geometries(b, sq, sk, h, kvh,
                                                        causal, off, want):
    """Non-causal, every key tile is seen: 24 tiles over 1,500 keys, 80
    blocks (20 groups x 4 requests) make 8 splits of 3 tiles; rep 6
    groups 6 rows a request, one 16-row block a group."""
    assert decode_splits(b, sq, sk, h, kvh, causal, off) == want


def _attn_check(got, want):
    """The card check of chip_smoke.py phase 5: about one bf16 ulp (f32
    2e-5) and an error norm within 1e-2 of the output's."""
    tol = BF16_ULP if got.dtype == torch.bfloat16 else dict(rtol=2e-5,
                                                            atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    rel = (got.float() - want.float()).norm() / want.float().norm()
    assert rel <= 1e-2


def _card_cases():
    cases = []
    for hd in (64, 80, 112, 128):
        for rep in (1, 3, 8):
            kvh = 1 if rep == 8 else 2
            for sq in (16, 23, 1920):
                b, sk, off = ((1, 2048, 0) if sq == 1920
                              else (2, sq + 37, 37))
                cases.append(((b, sq, sk, rep * kvh, kvh, hd), off, True))
    cases.append(((2, 64, 100, 6, 3, 64), 0, False))
    # whisper's encoder self-attention over 1,500 frames (every key tile
    # on every row, the last tile 28 keys) and its cross-attention from 23
    # decoder rows; internvl2's rep 6 at hd 128, 16 rows and its prefill
    cases += [((4, 1500, 1500, 20, 20, 64), 0, False),
              ((4, 23, 1500, 20, 20, 64), 0, False),
              ((2, 16, 800, 48, 8, 128), 0, True),
              ((4, 768, 800, 48, 8, 128), 0, True)]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("shape,q_offset,causal", _card_cases())
def test_tensor_core_prefill_on_card(shape, q_offset, causal):
    """bf16 prefill (Sq >= 16) on the tensor cores against the plain
    version: hd 64, 80, 112 and 128, rep 1, 3 and 8, Sq 16, 23 and 1,920,
    Sk not a multiple of 64; non-causal at Sk 1,500 (whisper) and rep 6
    at hd 128 (internvl2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_torch(x, "bfloat16").cuda()
               for x in _inputs(sum(shape), *shape, None))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert LAUNCHES["flash_attention"] == 1
    _attn_check(got, flash_attention_ref(q, k, v, causal=causal,
                                         q_offset=q_offset))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,q_offset,causal", [
    ((4, 1, 2048, 9, 3, 64), 0, True),
    ((4, 1, 2048, 9, 3, 64), 63, True),
    ((4, 1, 2048, 9, 3, 64), 64, True),
    ((4, 1, 2048, 9, 3, 64), 1920, True),
    ((4, 1, 2048, 9, 3, 64), 2047, True),
    ((2, 1, 77, 9, 3, 64), 76, True),        # Sk not a multiple of 64
    ((2, 1, 1000, 9, 3, 64), 300, True),     # 5 tiles: split, no remainder
    ((2, 3, 600, 9, 3, 64), 250, True),      # 4 tiles: one split
    ((2, 5, 300, 16, 2, 128), 290, True),    # 5 rows x rep 8, hd 128
    ((2, 15, 1000, 4, 4, 128), 600, True),   # rep 1, the most decode rows
    ((64, 1, 4096, 4, 1, 64), 4095, True),   # several tiles a split
    ((2, 1, 300, 6, 2, 64), 0, False),
    # whisper's cross-attention over 1,500 frames, non-causal: 8 splits of
    # 3 tiles, the last tile 28 keys; decode and a 4-token prompt
    ((4, 1, 1500, 20, 20, 64), 0, False),
    ((4, 4, 1500, 20, 20, 64), 0, False),
    # internvl2's decode, rep 6 at hd 128 over an 800-slot cache
    ((4, 1, 800, 48, 8, 128), 768, True),
    ((4, 1, 800, 48, 8, 128), 798, True),
])
def test_split_k_decode_on_card(shape, q_offset, causal, dtype):
    """The split-K decode (Sq < 16, both dtypes) against the plain
    version at several positions, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (_torch(x, dtype).cuda()
               for x in _inputs(sum(shape), *shape, None))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert LAUNCHES["flash_attention"] == 1
    _attn_check(got, flash_attention_ref(q, k, v, causal=causal,
                                         q_offset=q_offset))


# yi-34b (56 heads over 8: rep 7) and command-r-plus-104b (96 over 8: rep
# 12) at hd 128: a group's rows (position-major, ``rep`` rows a position)
# cross the kernel's 16-row tiles at positions that are no multiple of
# the tile, and a decode row's group fills most of a tile
WIDE_GQA = [(56, 8), (96, 8)]


@pytest.mark.parametrize("h,kvh", WIDE_GQA)
@pytest.mark.parametrize("sq,sk,causal", [(24, 40, True), (1, 70, True),
                                          (5, 33, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_ref_at_wide_gqa_groups(h, kvh, sq, sk, causal,
                                                 dtype):
    shape = (2, sq, sk, h, kvh, 128)
    _check_port(sum(shape), shape, causal, dtype, sk - sq if causal else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh", WIDE_GQA)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,sq,sk,q_offset", [
    (1, 512, 512, 0),      # a prefill
    (2, 23, 600, 577),     # a prefill at the end of a cache
    (4, 1, 2048, 2047),    # a decode step: split-K
    (4, 1, 2048, 100),     # early in the cache: one split
    (2, 3, 1000, 700),     # 21 / 36 rows a group
    (2, 15, 1000, 985),    # the most decode rows: 105 / 180 a group
])
def test_wide_gqa_groups_on_card(h, kvh, dtype, b, sq, sk, q_offset):
    """#7 at rep 7 and 12 (hd 128), prefill (Sq >= 16: the tensor cores in
    bf16, the CUDA cores in float32) and split-K decode, o and the rows'
    lse against the plain version: o within one bf16 ulp (float32 2e-5)
    and an error norm within 1e-2, lse within 1e-2 (bf16) and 1e-5
    (float32); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = (b, sq, sk, h, kvh, 128)
    q, k, v = (_torch(x, dtype).cuda()
               for x in _inputs(sum(shape), *shape, None))
    reset_launches()
    o, lse = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                             return_lse=True)
    assert LAUNCHES["flash_attention"] == 1
    po, pl = flash_attention_ref(q, k, v, causal=True, q_offset=q_offset,
                                 return_lse=True)
    _attn_check(o, po)
    lt = 1e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(lse, pl, rtol=lt, atol=lt)
