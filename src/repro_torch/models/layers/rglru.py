"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

A port of ``repro/models/layers/rglru.py``.  Temporal mixing:

    branch = W_in·x ;  gate = GeLU(W_gate·x)
    xc     = CausalConv1D(branch)                      (depthwise, width 4)
    r_t    = σ(W_a·xc + b_a);   i_t = σ(W_i·xc + b_i)
    log a_t = −c · softplus(Λ) · r_t                   (a_t ∈ (0,1))
    h_t    = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ xc)
    out    = W_out·(h ⊙ gate)

Prefill solves the recurrence with a log-depth scan over time with the
reference's combine (``linear_scan``: ⌈log₂ S⌉ steps of whole-tensor
PyTorch ops, where the JAX package calls ``jax.lax.associative_scan``);
no Pallas kernel is involved, so none is written.  The combine is
associative, but the two scans apply it in another order, so f32 results
differ by a few ulps.  Decode is one step of the recurrence with O(1)
state: (h, conv tail).

The reference's two perf flags (``sharding/flags.py``, default off):
``rglru_chunk`` C runs a prompt longer than C as a host loop over chunks
of C steps that carries h (``chunked_scan``; the padding of the last
chunk, a = 1 and b = 0, leaves h alone), each chunk through the
log-depth scan and, where autograd records (the loss), under
``torch.utils.checkpoint`` as the reference's ``jax.checkpoint``: the
scan's live set and its backward's residuals are one chunk's.
``rglru_block_gates`` draws ``w_a`` and ``w_i`` as 16 blocks of
(W/16)² (where 16 divides W), block-diagonal gates that
``_gate_matmul`` applies.

Dtypes as the reference's: the gate products in the compute dtype, then
f32 for a, b and the scan; h and the conv tail stored in x's dtype.  GeLU
is the tanh form (``jax.nn.gelu``'s default); softplus is
``logaddexp(x, 0)``, the JAX formula.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import normal
from repro_torch.sharding.flags import get_flags

#: Blocks of the block-local gates (``rglru_block_gates``).
GATE_BLOCKS = 16


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) recurrent state
    conv: torch.Tensor       # (B, conv_width − 1, W) conv tail


def _causal_conv(x, w):
    """Depthwise causal conv.  x: (B, S, W), w: (CW, W)."""
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def _gate_matmul(xc, w):
    """Full (W, W) gate, or block-local (P, W/P, W/P) gate (the JAX
    package's ``rglru_block_gates`` layout)."""
    if w.dim() == 2:
        return xc @ w
    p, bw, _ = w.shape
    b_, s, width = xc.shape
    xb = xc.reshape(b_, s, p, bw)
    return torch.einsum("bspw,pwv->bspv", xb, w).reshape(b_, s, width)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params, xc, c_exp):
    r = torch.sigmoid(_gate_matmul(xc, params["w_a"]) + params["b_a"])
    i = torch.sigmoid(_gate_matmul(xc, params["w_i"]) + params["b_i"])
    log_a = (-c_exp * _softplus(params["lam"].to(torch.float32))
             * r.to(torch.float32))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    b = beta * (i.to(torch.float32) * xc.to(torch.float32))
    return a, b


def linear_scan(a, b):
    """h_t = a_t·h_{t−1} + b_t from h_0 = 0 over axis 1, as an inclusive
    scan of the reference's combine (aₗ, bₗ)∘(aᵣ, bᵣ) = (aₗaᵣ, aᵣbₗ + bᵣ):
    step j folds in the element 2^j back (Hillis–Steele), ⌈log₂ S⌉ steps.
    Returns h, the shape of b."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, step:] = a[:, step:] * a[:, :-step]
        b_new[:, step:] = a[:, step:] * b[:, :-step] + b[:, step:]
        a, b = a_new, b_new
        step *= 2
    return b


def _chunk_step(hprev, a, b):
    """One chunk of ``chunked_scan``: the carried h folded into its first
    step, then the scan."""
    b = b.clone()
    b[:, 0] = b[:, 0] + a[:, 0] * hprev
    return linear_scan(a, b)


def chunked_scan(a, b, chunk: int):
    """``linear_scan`` over chunks of ``chunk`` steps, h carried from one
    to the next (the reference's ``lax.scan`` over chunks).  The sequence
    is padded to whole chunks with a = 1, b = 0 (state-neutral) and cut
    back.  Each chunk goes under ``torch.utils.checkpoint`` where autograd
    records."""
    bsz, s, w = a.shape
    pad = (-s) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    h = torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
    remat = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    hs = []
    for j in range(0, s + pad, chunk):
        aj, bj = a[:, j:j + chunk], b[:, j:j + chunk]
        if remat:
            hj = checkpoint(_chunk_step, h, aj, bj, use_reentrant=False)
        else:
            hj = _chunk_step(h, aj, bj)
        h = hj[:, -1]
        hs.append(hj)
    return torch.cat(hs, dim=1)[:, :s]


def rglru_apply(params, x, cfg, state: RGLRUState | None = None):
    """Prefill.  x: (B, S, D) → (B, S, D), final state."""
    rc = cfg.recurrent
    branch = x @ params["w_in"]                            # (B, S, W)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    if state is not None:
        xfull = torch.cat([state.conv.to(branch.dtype), branch], dim=1)
        xc = _causal_conv(xfull, params["conv"])[:, state.conv.shape[1]:]
    else:
        xc = _causal_conv(branch, params["conv"])
    a, b = _gates(params, xc, rc.c_exponent)               # (B, S, W) f32
    if state is not None:
        # fold the incoming state into the first step: h_1 = a_1 h_0 + b_1
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * state.h.to(torch.float32)
    chunk = get_flags().rglru_chunk
    if chunk and x.shape[1] > chunk:
        h = chunked_scan(a, b, chunk)
    else:
        h = linear_scan(a, b)
    out = (h.to(x.dtype) * gate) @ params["w_out"]
    cw1 = rc.conv_width - 1
    if branch.shape[1] >= cw1:
        tail = branch[:, -cw1:, :]
    else:
        tail = F.pad(branch, (0, 0, cw1 - branch.shape[1], 0))
    return out, RGLRUState(h=h[:, -1, :].to(x.dtype), conv=tail)


def rglru_decode_step(params, x, cfg, state: RGLRUState):
    """x: (B, 1, D), one step of the recurrence."""
    rc = cfg.recurrent
    branch = x @ params["w_in"]                            # (B, 1, W)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    xfull = torch.cat([state.conv.to(branch.dtype), branch], dim=1)
    xc = _causal_conv(xfull, params["conv"])[:, -1:, :]
    a, b = _gates(params, xc, rc.c_exponent)               # (B, 1, W)
    h = a[:, 0] * state.h.to(torch.float32) + b[:, 0]
    out = (h[:, None, :].to(x.dtype) * gate) @ params["w_out"]
    conv_tail = xfull[:, -(rc.conv_width - 1):, :]
    return out, RGLRUState(h=h.to(x.dtype), conv=conv_tail)


def init_rglru_state(batch: int, cfg, dtype, device=None) -> RGLRUState:
    rc = cfg.recurrent
    return RGLRUState(
        h=torch.zeros((batch, rc.width), dtype=dtype, device=device),
        conv=torch.zeros((batch, rc.conv_width - 1, rc.width), dtype=dtype,
                         device=device),
    )


def init_rglru(gen, cfg, dtype):
    """Random weights with the JAX init's shapes and scales: full (W, W)
    gates (the JAX package's default), or with ``rglru_block_gates`` and
    16 dividing W, 16 blocks of (W/16)² each scaled (W/16)^-1/2."""
    d = cfg.d_model
    w = cfg.recurrent.width
    cw = cfg.recurrent.conv_width
    dev = gen.device
    gate_shape, gate_scale = (w, w), w ** -0.5
    if get_flags().rglru_block_gates and w % GATE_BLOCKS == 0:
        bw = w // GATE_BLOCKS
        gate_shape, gate_scale = (GATE_BLOCKS, bw, bw), bw ** -0.5
    return {
        "w_in": normal(gen, (d, w), d ** -0.5, dtype),
        "w_gate": normal(gen, (d, w), d ** -0.5, dtype),
        "conv": normal(gen, (cw, w), cw ** -0.5, dtype),
        "w_a": normal(gen, gate_shape, gate_scale, dtype),
        "b_a": torch.zeros((w,), dtype=dtype, device=dev),
        "w_i": normal(gen, gate_shape, gate_scale, dtype),
        "b_i": torch.zeros((w,), dtype=dtype, device=dev),
        # Λ so that a ≈ 0.9–0.999 under r ≈ 0.5 (Griffin's init range)
        "lam": torch.linspace(0.0, 2.0, w, device=dev).to(dtype),
        "w_out": normal(gen, (w, d), w ** -0.5, dtype),
    }
