"""Mamba2 (SSD, state-space duality, arXiv:2405.21060): the mixer and the
attention-free LM (the JAX package's ``models/mamba2.py``).

Chunked SSD: an intra-chunk quadratic (attention-like) term plus the
inter-chunk state recurrence, a loop over chunks that emits the state on
entry to each chunk (the JAX ``lax.scan``). A single-token state update
serves decode. Plain PyTorch: no kernel.

Discretization: h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,
y_t = C_t h_t + D x_t, with a per-head scalar A < 0 and one B/C group.

Where the JAX module leaves a choice to XLA or a library, the port fixes
it: the depthwise causal conv sums its K shifted products in order
j = 0..K-1 in the activation dtype (not ``F.conv1d``); softplus is
``logaddexp(x, 0)`` (``jax.nn.softplus``, no threshold); each
three-operand einsum is two explicit products, so that none forms a
[B, nc, Q, Q, H, P] intermediate. The intra-chunk decay matrix is
``exp(where(mask, seg, -inf))``, the mask applied before the exponential:
the JAX module takes ``where(mask, exp(seg), 0)``, whose exponential
overflows above the diagonal at real chunk lengths, which turns its
gradient into NaN (0 x inf); the forward values are the same.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers, spec
from .config import ModelConfig
from .spec import PSpec, no_sharding, tree_map

States = Tuple[torch.Tensor, torch.Tensor]  # (ssm [L,B,H,P,N], conv [L,B,K-1,C])


def mamba_specs(cfg: ModelConfig, L=()) -> Dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    conv_dim = di + 2 * n
    dt = cfg.dtype
    f32 = torch.float32
    lax_ = (None,) * len(L)
    inner = lax_ + ("d_inner",)
    return {
        "in_proj": PSpec(L + (d, 2 * di + 2 * n + h), dt,
                         axes=lax_ + ("embed", "d_inner")),
        "conv_w": PSpec(L + (conv_dim, k), dt, axes=inner + (None,)),
        "conv_b": PSpec(L + (conv_dim,), f32, "zeros", axes=inner),
        "A_log": PSpec(L + (h,), f32, "ones"),
        "D": PSpec(L + (h,), f32, "ones"),
        "dt_bias": PSpec(L + (h,), f32, "zeros"),
        "norm": PSpec(L + (di,), f32, "ones", axes=inner),
        "out_proj": PSpec(L + (di, d), dt, axes=inner + ("embed",)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _pad_seq(x: torch.Tensor, before: int = 0, after: int = 0
             ) -> torch.Tensor:
    """``x`` [B, S, ...] with ``before`` and ``after`` zero rows along S
    (``F.pad``'s values), by a concatenation: on a DTensor sharded on
    another dim, torch 2.11's ``F.pad`` gives shards that a later op
    meets at the wrong width."""
    def zeros(n):
        return x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))

    parts = ([zeros(before)] if before else []) + [x] + (
        [zeros(after)] if after else [])
    return torch.cat(parts, 1) if len(parts) > 1 else x


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [C, K]; returns silu(conv)."""
    k = w.shape[-1]
    s = x.shape[1]
    xp = _pad_seq(x, before=k - 1)
    out = xp[:, 0:s, :] * w[:, 0].to(x.dtype)
    for j in range(1, k):
        out = out + xp[:, j:j + s, :] * w[:, j].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _ssd_chunked(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                 a_log: torch.Tensor, b_: torch.Tensor, c_: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """x: [B, S, H, P] (the silu'd conv output); dt: [B, S, H] float32
    (softplus'd); b_, c_: [B, S, N]. Returns (y [B, S, H, P] in x's
    dtype, final state [B, H, P, N] float32)."""
    bsz, s_orig, h, p = x.shape
    n = b_.shape[-1]
    q = min(cfg.ssm_chunk, s_orig)
    pad = (-s_orig) % q
    if pad:  # ragged tail: dt = 0 padding is exact (decay 1, no input)
        x, dt, b_, c_ = (_pad_seq(t, after=pad) for t in (x, dt, b_, c_))
    s = s_orig + pad
    nc = s // q
    fa = -torch.exp(a_log.float())                               # [H] < 0
    a = dt * fa                                                  # [B,S,H]
    xdt = x * dt[..., None].to(x.dtype)                          # dt-weighted

    acs = torch.cumsum(a.reshape(bsz, nc, q, h), dim=2)          # [B,nc,Q,H]
    xc = xdt.reshape(bsz, nc, q, h, p).float()
    bc = b_.reshape(bsz, nc, q, n).float()
    cc = c_.reshape(bsz, nc, q, n).float()

    # intra-chunk: decay L[q, k] = exp(acs_q - acs_k) for k <= q, the mask
    # before the exponential
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]          # [B,nc,Q,K,H]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                  torch.full((), -torch.inf,
                                             device=x.device)))
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * l_mat, xc)

    # per-chunk end states
    decay_out = torch.exp(acs[:, :, -1:, :] - acs)               # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchpn", bc,
                          xc * decay_out[..., None])
    chunk_decay = torch.exp(acs[:, :, -1, :])                    # [B,nc,H]

    # inter-chunk recurrence: the state entering each chunk
    st = (torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # [B,nc,H,P,N]

    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) \
        * torch.exp(acs)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(x.dtype), st


class _GradOn(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    placements ``pl``."""

    @staticmethod
    def forward(ctx, t, mesh, pl):
        ctx.args = (mesh, pl)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.args), None, None


def _ssd_on_ranks(cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor,
                  a_log: torch.Tensor, b_: torch.Tensor, c_: torch.Tensor,
                  init_state: Optional[torch.Tensor], sh):
    """``_ssd_chunked`` where ``x`` is a DTensor: each rank scans its own
    sequences and heads, as the rules of ``sh`` place them (x, dt and the
    state on the batch and the heads, B and C on the batch, A on the
    heads). The SSD is independent per sequence and per head, so no rank
    needs another's values: the partitioning XLA gives the JAX scan. On
    DTensors the scan's einsums flatten the batch and the heads into one
    matmul batch dim, which torch 2.11 refuses in the backward where both
    are sharded.

    Each input is redistributed to those placements and its local tensor
    taken; the gradient of an input that is whole over a mesh dim that
    splits x (B and C over the heads, A over the batch) is this rank's
    part of a sum over it (``Partial``). The gradients of the activations
    go to the batch rows, split over the batch axes and the model axis
    (``_GradOn``): the projection's slices arrive whole on the model
    axis, and a gradient sharded on the heads, sliced back into the
    projection's wider dim, would be gathered whole and the projection's
    backward run whole on every rank. Returns y [B, S, H, P] and the
    state [B, H, P, N] placed on the batch and the heads, each
    shard contiguous (a padded scan's y is a slice)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh, rules = x.device_mesh, sh.rules

    def pl(shape, axes):
        return spec.placements(rules.pspec_for_shape(shape, axes, mesh),
                               mesh)

    heads = ("batch", None, "d_inner")
    state_axes = ("batch", "d_inner", None, None)
    split = {i for i, q in enumerate(pl(x.shape, heads + (None,)))
             if isinstance(q, Shard)}

    # the gradients of the activations go to the batch rows over the batch
    # axes and the model axis, the rows the projections' backward takes
    rows = tuple(n for n, q in zip(mesh.mesh_dim_names,
                                   pl(x.shape, ("batch",)))
                 if isinstance(q, Shard)) + (rules.model,)
    sizes = spec.axis_sizes(mesh)
    if x.shape[0] % math.prod(sizes[n] for n in rows):
        rows = rows[:-1]
    rows = spec.placements((rows or None,), mesh)

    def local(t, axes):
        want = pl(t.shape, axes)
        grad = [q if isinstance(q, Shard) or i not in split else Partial()
                for i, q in enumerate(want)]
        if axes[0] == "batch":
            t = _GradOn.apply(t, mesh, rows)
        return t.redistribute(mesh, want).to_local(grad_placements=grad)

    y, st = _ssd_chunked(
        cfg, local(x, heads + (None,)), local(dt, heads),
        local(a_log, ("d_inner",)), local(b_, ("batch", None, None)),
        local(c_, ("batch", None, None)),
        None if init_state is None else local(init_state, state_axes))
    st_shape = torch.Size((x.shape[0], x.shape[2], x.shape[3],
                           b_.shape[-1]))
    return (DTensor.from_local(y.contiguous(), mesh,
                               pl(x.shape, heads + (None,)),
                               run_check=False, shape=x.shape,
                               stride=spec.contiguous_stride(x.shape)),
            DTensor.from_local(st.contiguous(), mesh,
                               pl(st_shape, state_axes),
                               run_check=False, shape=st_shape,
                               stride=spec.contiguous_stride(st_shape)))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                dtype) -> torch.Tensor:
    """Mamba2's gated RMSNorm, norm(y * silu(z)), in float32, eps 1e-6."""
    g = y * F.silu(z.float()).to(y.dtype)
    gf = g.float()
    return (gf * torch.rsqrt((gf * gf).mean(-1, keepdim=True) + 1e-6)
            * scale).to(dtype)


def apply_mamba(cfg: ModelConfig, p, x: torch.Tensor,
                init_state: Optional[torch.Tensor] = None,
                return_state: bool = False, sh=None):
    """The mixer: in_proj -> conv -> SSD -> gated norm -> out_proj. x:
    [B, S, D] -> (out, None), or with ``return_state`` (out, (final ssm
    state [B, H, P, N] float32, conv state [B, K-1, C]: the last K-1
    pre-conv inputs))."""
    from torch.distributed.tensor import DTensor
    sh = sh or no_sharding
    bsz, s, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc_raw, dtr = _split_proj(cfg, x @ p["in_proj"])
    z = sh(z, "batch", "seq", "d_inner")
    xbc = sh(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]), "batch", "seq",
             "d_inner")
    xs = xbc[..., :di].reshape(bsz, s, h, cfg.ssm_headdim)
    b_ = xbc[..., di:di + n]
    c_ = xbc[..., di + n:]
    dt = softplus(dtr.float() + p["dt_bias"])
    if isinstance(xs, DTensor) and getattr(sh, "rules", None) is not None:
        y, final_state = _ssd_on_ranks(cfg, xs, dt, p["A_log"], b_, c_,
                                       init_state, sh)
    else:
        y, final_state = _ssd_chunked(cfg, xs, dt, p["A_log"], b_, c_,
                                      init_state)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    g = _gated_norm(y.reshape(bsz, s, di), z, p["norm"], x.dtype)
    out = sh(g @ p["out_proj"], "batch", "seq", "model_dim_act")
    if return_state:
        k = cfg.ssm_conv
        conv_state = _pad_seq(xbc_raw[:, max(s - (k - 1), 0):, :],
                              before=max(k - 1 - s, 0))
        return out, (final_state, conv_state)
    return out, None


def mamba_decode(cfg: ModelConfig, p, xt: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor, sh=None):
    """One-token step. xt: [B, D]; ssm_state: [B, H, P, N]; conv_state:
    [B, K-1, C] (pre-activation conv inputs). Returns (out [B, D], new ssm
    state, new conv state). ``sh`` is taken and not called, as in the JAX
    package."""
    bsz = xt.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc_new, dtr = _split_proj(cfg, xt @ p["in_proj"])
    xfull = torch.cat([conv_state, xbc_new[:, None, :]], dim=1)
    conv = xfull[:, 0, :] * p["conv_w"][:, 0].to(xt.dtype)
    for j in range(1, cfg.ssm_conv):
        conv = conv + xfull[:, j, :] * p["conv_w"][:, j].to(xt.dtype)
    xbc = F.silu(conv + p["conv_b"].to(xt.dtype))
    xs = xbc[:, :di].reshape(bsz, h, cfg.ssm_headdim).float()
    b_ = xbc[:, di:di + n].float()
    c_ = xbc[:, di + n:].float()
    dt = softplus(dtr.float() + p["dt_bias"])                    # [B,H]
    decay = torch.exp(dt * -torch.exp(p["A_log"].float()))       # [B,H]
    upd = (dt[:, :, None] * xs)[..., None] * b_[:, None, None, :]
    new_state = ssm_state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c_, new_state) \
        + p["D"][None, :, None] * xs
    g = _gated_norm(y.reshape(bsz, di), z, p["norm"], xt.dtype)
    out = g @ p["out_proj"]
    return out, new_state.to(ssm_state.dtype), xfull[:, 1:, :]


# ------------------------------------------------------------ the LM (ssm)
def param_specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": layers.embed_specs(cfg),
        "blocks": {"ln": layers.norm_specs(cfg, (cfg.n_layers,)),
                   "mamba": mamba_specs(cfg, (cfg.n_layers,))},
        "final_norm": layers.norm_specs(cfg),
    }


def residual_block(cfg: ModelConfig, blk, x: torch.Tensor,
                   sh=None) -> torch.Tensor:
    h, _ = apply_mamba(cfg, blk["mamba"],
                       layers.apply_norm(cfg, blk["ln"], x), sh=sh)
    return x + h


def logits(cfg: ModelConfig, params, tokens: torch.Tensor,
           remat: str = "none", sh=None) -> torch.Tensor:
    """The logits [B, S, vocab_padded] of one causal forward over
    ``tokens`` [B, S], each layer one checkpoint under ``remat``."""
    sh = sh or no_sharding
    run = layers.remat_runner(remat)
    x = sh(layers.embed_tokens(params["embed"], tokens), "batch", "seq",
           "model_dim_act")
    blocks = params["blocks"]
    for i in range(cfg.n_layers):  # layer i's parameters: views of the stack
        x = run(lambda blk, y: residual_block(cfg, blk, y, sh),
                tree_map(lambda w: w[i], blocks), x)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x, sh)


def train_loss(cfg: ModelConfig, params, batch: Dict,
               remat: str = "dots_no_batch", sh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S] (the
    last position masked), each layer one checkpoint under ``remat``."""
    tokens = batch["tokens"]
    return layers.next_token_loss(cfg, logits(cfg, params, tokens, remat, sh),
                                  tokens)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            max_len: Optional[int] = None, sh=None):
    """Returns (last-position logits [B, 1, vocab_padded] float32,
    (ssm states [L, B, H, P, N] float32, conv states [L, B, K-1, C])).
    The state does not grow with the length: ``max_len`` is ignored."""
    x = layers.embed_tokens(params["embed"], tokens)
    states = state_zeros(cfg, tokens.shape[0], tokens.device, sh, x)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        blk = tree_map(lambda w: w[i], blocks)
        h, (ss, cs) = apply_mamba(cfg, blk["mamba"],
                                  layers.apply_norm(cfg, blk["ln"], x),
                                  return_state=True, sh=sh)
        x = x + h
        states[0][i] = ss
        states[1][i] = cs
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x[:, -1:], sh), states


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: torch.Tensor,
                states: States, pos: Optional[int] = None, sh=None):
    """token: [B, 1]; states as ``prefill`` returns them, updated in place
    and returned with the logits [B, 1, vocab_padded] float32. The step
    does not depend on the position: ``pos`` is ignored."""
    x = layers.embed_tokens(params["embed"], token)[:, 0, :]
    ssm, conv = states
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        blk = tree_map(lambda w: w[i], blocks)
        xn = layers.apply_norm(cfg, blk["ln"], x[:, None, :])[:, 0, :]
        h, ss, cs = mamba_decode(cfg, blk["mamba"], xn, ssm[i], conv[i], sh)
        x = x + h
        ssm[i] = ss
        conv[i] = cs
    x = layers.apply_norm(cfg, params["final_norm"], x[:, None, :])
    return layers.unembed(cfg, params["embed"], x, sh), states


def state_specs(cfg: ModelConfig, batch: int,
                max_len: Optional[int] = None):
    """The decode state's PSpecs (``max_len`` ignored, as in ``prefill``)."""
    di, n = cfg.d_inner, cfg.ssm_state
    return (
        PSpec((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_headdim, n),
              torch.float32, "zeros",
              axes=(None, "batch", None, None, None)),
        PSpec((cfg.n_layers, batch, cfg.ssm_conv - 1, di + 2 * n),
              cfg.dtype, "zeros", axes=(None, "batch", None, "d_inner")),
    )


def state_zeros(cfg: ModelConfig, batch: int, device, sh=None,
                like=None) -> States:
    """The zero decode state, placed by the rules of ``sh`` on the mesh of
    ``like`` where that is a DTensor (``spec.zeros``)."""
    return tuple(spec.zeros(s, device, sh, like)
                 for s in state_specs(cfg, batch))
