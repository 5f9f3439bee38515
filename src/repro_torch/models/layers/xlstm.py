"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

A port of ``repro/models/layers/xlstm.py``.  Block skeleton (both kinds):

    u = x·W_up → (a, g);  h = core(a);  out = W_down(h ⊙ SiLU(g))

with a the first d_model columns of u and g the other H·dh, the core's
output width (the reduced config has H·dh = 32 ≠ d_model = 64).

mLSTM core (per head, matrix memory C ∈ R^{dh×dh}, stabiliser m):

    C_t = f'_t C_{t−1} + i'_t v_t k_tᵀ ;  n_t = f'_t n_{t−1} + i'_t k_t
    h_t = C_t q_t / max(|n_tᵀ q_t|, e^{−m_t}),  m_t = max(log f_t + m_{t−1}, ĩ_t)

Prefill runs the chunkwise form: a host loop over chunks of
``chunk_size`` carrying (C, n, m) in f32 (the JAX package's ``lax.scan``),
within a chunk the W × W decay-masked products as batched PyTorch
products.  S is padded to a chunk multiple with state-neutral steps
(input gate NEG ⇒ i' = 0, forget logit 40 ⇒ log f ≈ 0), so the carried
state is exact whatever the padding.  Decode is one step of the
recurrence.

sLSTM core: scalar memory with recurrent gate mixing through
``r_gates`` (H, dh, 4, dh).  The recurrence is not associative, so
prefill is a host loop over time (the JAX package's ``lax.scan``) and
decode the same loop at S = 1.

No Pallas kernel is involved in either core, so none is written.  Dtypes
as the reference's: gates and carried state in f32 inside a call; the
final mLSTM C and n and every sLSTM state field are cast to the
activation dtype, mLSTM's m stays f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, H, dh, dh)
    n: torch.Tensor    # (B, H, dh)
    m: torch.Tensor    # (B, H) f32


class SLSTMState(NamedTuple):
    h: torch.Tensor    # (B, H, dh)
    c: torch.Tensor    # (B, H, dh)
    n: torch.Tensor    # (B, H, dh)
    m: torch.Tensor    # (B, H, dh)


NEG = -1e30
_F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_qkvg(params, a, xcfg):
    b, s, _ = a.shape
    h, dh = xcfg.n_heads, xcfg.head_dim
    q = (a @ params["wq"]).reshape(b, s, h, dh) * (dh ** -0.5)
    k = (a @ params["wk"]).reshape(b, s, h, dh)
    v = (a @ params["wv"]).reshape(b, s, h, dh)
    ig = (a @ params["wi"]).to(_F32)                       # (B, S, H)
    fg = (a @ params["wf"]).to(_F32)                       # (B, S, H)
    return q, k, v, ig, fg


def _mlstm_chunk(carry, qc, kc, vc, igc, lfc):
    """One chunk of W steps.  carry: (C0, n0, m0) f32; qc, kc, vc
    (B, H, W, dh); igc, lfc (B, H, W) f32.  Returns (carry, h)."""
    C0, n0, m0 = carry
    w = qc.shape[2]
    Fc = torch.cumsum(lfc, dim=-1)                         # inclusive
    Ftot = Fc[..., -1]
    # D_ts = F_t − F_s + ĩ_s for s ≤ t
    Dm = Fc[..., :, None] - Fc[..., None, :] + igc[..., None, :]
    tri = torch.ones((w, w), dtype=torch.bool, device=qc.device).tril()
    Dm = torch.where(tri, Dm, NEG)
    m_intra = torch.amax(Dm, dim=-1)                       # (B, H, W)
    m_t = torch.maximum(Fc + m0[..., None], m_intra)
    Sw = torch.exp(Dm - m_t[..., None])                    # (B, H, W, W)
    g_t = torch.exp(Fc + m0[..., None] - m_t)              # (B, H, W)

    q32, k32, v32 = qc.to(_F32), kc.to(_F32), vc.to(_F32)
    qk = torch.einsum("bhtd,bhsd->bhts", qc, kc).to(_F32)
    intra = torch.einsum("bhts,bhsd->bhtd", Sw * qk, v32)
    inter = g_t[..., None] * torch.einsum("bhde,bhte->bhtd", C0, q32)
    n_t = g_t[..., None] * n0[..., None, :] + torch.einsum(
        "bhts,bhsd->bhtd", Sw, k32)
    qn = torch.einsum("bhtd,bhtd->bht", n_t, q32)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
    h = (intra + inter) / denom[..., None]                 # (B, H, W, dh)

    # chunk-end carry
    m_out = torch.maximum(Ftot + m0,
                          torch.amax(Ftot[..., None] - Fc + igc, dim=-1))
    wts = torch.exp(Ftot[..., None] - Fc + igc - m_out[..., None])
    decay = torch.exp(Ftot + m0 - m_out)
    C_new = decay[..., None, None] * C0 + torch.einsum(
        "bhs,bhsd,bhse->bhde", wts, v32, k32)
    n_new = decay[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", wts, k32)
    return (C_new, n_new, m_out), h


def mlstm_chunkwise(params, a, xcfg, state: MLSTMState):
    """a: (B, S, D) → (B, S, H·dh), final state."""
    b, s, _ = a.shape
    H, dh = xcfg.n_heads, xcfg.head_dim
    W = min(xcfg.chunk_size, s)
    q, k, v, ig, fg = _mlstm_qkvg(params, a, xcfg)
    pad = (-s) % W
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad), value=NEG)      # i' = 0: no write
        fg = F.pad(fg, (0, 0, 0, pad), value=40.0)     # log σ(40) ≈ 0
    sp = s + pad
    nc = sp // W

    def chunks(t):                                     # (nc, B, H, W, ...)
        t = t.reshape(b, nc, W, H, *t.shape[3:])
        return t.permute(1, 0, 3, 2, *range(4, t.dim()))

    # ``unbind``, not ``x[c]``: its backward stacks the chunks' gradients
    # once, where each slice's backward writes a zero tensor of the
    # whole (quadratic in the chunks)
    per_chunk = zip(*(chunks(t).unbind(0) for t in
                      (q, k, v, ig, F.logsigmoid(fg))))
    carry = (state.C.to(_F32), state.n.to(_F32), state.m.to(_F32))
    hs = []
    for qc, kc, vc, igc, lfc in per_chunk:
        carry, h = _mlstm_chunk(carry, qc, kc, vc, igc, lfc)
        hs.append(h)
    # (nc, B, H, W, dh) → (B, S, H·dh)
    out = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(b, sp, H * dh)
    Cf, nf, mf = carry
    return (out.to(a.dtype)[:, :s],
            MLSTMState(C=Cf.to(a.dtype), n=nf.to(a.dtype), m=mf))


def mlstm_decode_step(params, a, xcfg, state: MLSTMState):
    """a: (B, 1, D) → (B, 1, H·dh), new state."""
    b = a.shape[0]
    H, dh = xcfg.n_heads, xcfg.head_dim
    q, k, v, ig, fg = _mlstm_qkvg(params, a, xcfg)
    q, k, v = q[:, 0].to(_F32), k[:, 0].to(_F32), v[:, 0].to(_F32)
    ig, lf = ig[:, 0], F.logsigmoid(fg[:, 0])              # (B, H)
    m0 = state.m.to(_F32)
    m_new = torch.maximum(lf + m0, ig)
    fprime = torch.exp(lf + m0 - m_new)[..., None]
    iprime = torch.exp(ig - m_new)[..., None]
    C = fprime[..., None] * state.C.to(_F32) + iprime[..., None] * (
        v[..., :, None] * k[..., None, :])
    n = fprime * state.n.to(_F32) + iprime * k
    qn = torch.sum(n * q, dim=-1)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    h = torch.einsum("bhde,bhe->bhd", C, q) / denom[..., None]
    out = h.reshape(b, 1, H * dh).to(a.dtype)
    return out, MLSTMState(C=C.to(a.dtype), n=n.to(a.dtype), m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_scan(params, a, xcfg, state: SLSTMState):
    """a: (B, S, D) → (B, S, H·dh), final state: a host loop over S."""
    b, s, _ = a.shape
    H, dh = xcfg.n_heads, xcfg.head_dim
    gates_x = (a @ params["w_gates"]).reshape(b, s, H, 4, dh).to(_F32)
    # "bhd,hdge->bhge" as one batched product over heads
    r = params["r_gates"].to(_F32).reshape(H, dh, 4 * dh)
    h, c, n, m = (x.to(_F32) for x in state)
    hs = []
    # ``unbind`` (one stack in the backward), as in ``mlstm_chunkwise``
    for gx in gates_x.unbind(1):
        rec = torch.bmm(h.transpose(0, 1), r).reshape(H, b, 4, dh)
        z = gx + rec.transpose(0, 1)                        # (B, H, 4, dh)
        it, ft, zt, ot = z.unbind(2)
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = torch.sigmoid(ot) * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, s, H * dh).to(a.dtype)
    return out, SLSTMState(*(x.to(a.dtype) for x in (h, c, n, m)))


def slstm_decode_step(params, a, xcfg, state: SLSTMState):
    return slstm_scan(params, a, xcfg, state)


# ---------------------------------------------------------------------------
# block wrapper, state, init
# ---------------------------------------------------------------------------

def xlstm_block_apply(kind, params, x, cfg, state, *, decode: bool):
    """The block's temporal mixing: up-projection, core, gate, down
    projection.  Returns (out, new state)."""
    xcfg = cfg.xlstm
    d = cfg.d_model
    u = x @ params["w_up"]                                 # (B, S, D + H·dh)
    a, g = u[..., :d], u[..., d:]
    if kind == "mlstm":
        core = mlstm_decode_step if decode else mlstm_chunkwise
    else:
        core = slstm_decode_step if decode else slstm_scan
    h, new_state = core(params, a, xcfg, state)
    return (h * F.silu(g)) @ params["w_down"], new_state


def init_xlstm_state(kind: str, batch: int, cfg, dtype, device=None):
    """A zero state; m starts at 0.0, as the reference's."""
    H, dh = cfg.xlstm.n_heads, cfg.xlstm.head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind == "mlstm":
        return MLSTMState(C=zeros((batch, H, dh, dh)), n=zeros((batch, H, dh)),
                          m=zeros((batch, H), _F32))
    return SLSTMState(h=zeros((batch, H, dh)), c=zeros((batch, H, dh)),
                      n=zeros((batch, H, dh)), m=zeros((batch, H, dh), _F32))


def init_xlstm_block(gen, kind: str, cfg, dtype):
    """Random weights with the JAX init's shapes and scales."""
    d = cfg.d_model
    H, dh = cfg.xlstm.n_heads, cfg.xlstm.head_dim
    inner = H * dh
    p = {"w_up": normal(gen, (d, d + inner), d ** -0.5, dtype),
         "w_down": normal(gen, (inner, d), inner ** -0.5, dtype)}
    if kind == "mlstm":
        p.update(
            wq=normal(gen, (d, inner), d ** -0.5, dtype),
            wk=normal(gen, (d, inner), d ** -0.5, dtype),
            wv=normal(gen, (d, inner), d ** -0.5, dtype),
            wi=normal(gen, (d, H), d ** -0.5, dtype),
            # forget gates open at init: logits around +2
            wf=(normal(gen, (d, H), d ** -0.5, _F32) + 2.0).to(dtype))
    else:
        p.update(
            w_gates=normal(gen, (d, 4 * inner), d ** -0.5, dtype),
            r_gates=normal(gen, (H, dh, 4, dh), dh ** -0.5, dtype))
    return p
