"""Bayesian A-optimal experimental design (paper §3.1, Corollary 9; App. D).

Ports the single-device half of ``repro/core/objectives/a_optimal.py``
with an explicit lane axis (see ``base.py``):

    f(S) = Tr(Λ⁻¹) − Tr((Λ + σ⁻² X_S X_Sᵀ)⁻¹),   Λ = β² I

Each lane's state carries M = Λ + σ⁻² X_S X_Sᵀ, its Cholesky factor L
and the cached shared solve W = M⁻¹X, refreshed once per ``add_set`` so
the singleton-gain and filter-engine oracles never re-pay the (d, d, n)
triangular solves.

* Singleton gains (Sherman–Morrison), all lanes in one ``aopt_gains``
  call:  f_S(a) = σ⁻² ‖w_a‖² / (1 + σ⁻² x_aᵀ w_a).
* Set gains (Woodbury), C = X_R:
  f_S(R) = σ⁻² Tr((I + σ⁻² CᵀM⁻¹C)⁻¹ (M⁻¹C)ᵀ(M⁻¹C)).
* Filter engine: the perturbed precision of S ∪ R_i splits as
  M_i⁻¹ = M⁻¹ − E_i E_iᵀ (``expand_factors``), so ``filter_gains_batch``
  scores every lane's samples against the shared W in one
  ``aopt_filter_gains`` call.

The two gain oracles go to the hand-written kernels whenever the
objective lives on the card — unlike the JAX reference, whose objective
defaults to its jnp references (``use_kernel=False``).  The Cholesky
factorizations, triangular solves and Woodbury factors stay
``torch.linalg`` and ``torch.matmul``, batched over lanes, because the
reference computes them outside any Pallas kernel; they keep its
formulas so the two agree.

The ``dist_*`` methods are the sharded runtime's column-based contract
(``base.DistributedObjective``): M and its factor L are the same on
every rank, the shared solve W = M⁻¹X_local is the shard's (refreshed
once per ``dist_add_set``), and the sweeps run kernel 4 and kernel 5
(on the Woodbury factors of the gathered columns) on the shard.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.objectives.base import gather_columns, mark_selected
from repro_torch.kernels.aopt_gains.ops import aopt_gains
from repro_torch.kernels.common import (
    resolve_device,
    resolve_precision,
    set_full_f32_matmul,
    stream_dtype,
)
from repro_torch.kernels.filter_gains.ops import aopt_filter_gains


class AOptState(NamedTuple):
    M: torch.Tensor          # (G, d, d) posterior precision
    L: torch.Tensor          # (G, d, d) chol(M)
    W: torch.Tensor          # (G, d, n) cached shared solve M⁻¹X
    sel_mask: torch.Tensor   # (G, n) bool
    value: torch.Tensor      # (G,) f32


class AOptDistState(NamedTuple):
    """The sharded runtime's state: M and L replicated, W the shard's."""

    M: torch.Tensor          # (G, d, d) posterior precision — replicated
    L: torch.Tensor          # (G, d, d) chol(M) — replicated
    W: torch.Tensor          # (G, d, n_local) M⁻¹X_local — the shard's


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class AOptimalityObjective:
    """Bayesian A-optimality oracle.  X: (d, n) stimuli columns.

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path.  On the card it turns
    TF32 off for matmul and cuDNN: the reference is full f32.
    ``use_filter_engine=False`` sends DASH, FAST and adaptive sequencing
    through the per-sample ``gains(add_set(...))`` path.
    """

    def __init__(self, X, kmax: int, *, beta2: float = 1.0,
                 sigma2: float = 1.0, use_filter_engine: bool = True,
                 precision: str | None = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_full_f32_matmul()
        self.X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        self.X = self.X.contiguous()
        self.d, self.n = self.X.shape
        self.kmax = int(kmax)
        self.beta2 = float(beta2)
        self.isig2 = 1.0 / float(sigma2)
        self.use_filter_engine = bool(use_filter_engine)
        self.precision = resolve_precision(precision)
        self.tr_prior = self.d / self.beta2          # Tr(Λ⁻¹)

    def _x_stream(self):
        """X in the streamed storage dtype, made once per precision view."""
        if getattr(self, "_xs", None) is None:
            self._xs = self.X.to(stream_dtype(self.precision))
        return self._xs

    def _eye(self, m: int):
        return torch.eye(m, dtype=torch.float32, device=self.device)

    def _chol(self, M):
        # cholesky_ex: no host sync to check the factorization; M is
        # β²I + σ⁻²X_SX_Sᵀ, positive definite by construction.
        return torch.linalg.cholesky_ex(M).L

    def _trace_inv(self, L):
        """(G,) Tr(M⁻¹) = ‖L⁻¹‖_F² via a triangular solve against I."""
        Z = _solve_lower(L, self._eye(self.d).expand_as(L))
        return torch.sum(Z * Z, dim=(-2, -1))

    # -- state ------------------------------------------------------------
    def init(self, lanes: int = 1) -> AOptState:
        eye = self._eye(self.d)
        return AOptState(
            M=(self.beta2 * eye).repeat(lanes, 1, 1),
            L=(math.sqrt(self.beta2) * eye).repeat(lanes, 1, 1),
            W=(self.X / self.beta2).repeat(lanes, 1, 1),
            sel_mask=torch.zeros((lanes, self.n), dtype=torch.bool,
                                 device=self.device),
            value=torch.zeros((lanes,), device=self.device),
        )

    def value(self, state: AOptState):
        return state.value

    # -- oracles ----------------------------------------------------------
    def _minv(self, L, B):
        """M⁻¹B per lane: L (G, d, d), B (G, d, c)."""
        return torch.linalg.solve_triangular(L.mT, _solve_lower(L, B),
                                             upper=True)

    def _minv_cols(self, L, C):
        """M⁻¹C for C (G, S, d, m): all S·m columns of a lane in one pair
        of solves.  Returns (G, S, d, m)."""
        g, s, d, m = C.shape
        P = self._minv(L, C.permute(0, 2, 1, 3).reshape(g, d, s * m))
        return P.reshape(g, d, s, m).permute(0, 2, 1, 3)

    def gains(self, state: AOptState):
        """(G, n) Sherman–Morrison gains, one kernel call for all lanes
        (state.W is the cached shared solve)."""
        g = aopt_gains(self._x_stream(), state.W, self.isig2,
                       precision=self.precision)
        return torch.where(state.sel_mask, torch.zeros_like(g), g)

    def gains_subset(self, state: AOptState, idx):
        """(G, B) singleton gains for the candidate subsets idx (G, B) —
        a column gather plus the same sweep, one call per lane."""
        g = torch.stack([
            aopt_gains(self.X[:, idx[i]], state.W[i][:, idx[i]], self.isig2,
                       precision=self.precision)
            for i in range(idx.shape[0])
        ])
        sel = torch.gather(state.sel_mask, 1, idx)
        return torch.where(sel, torch.zeros_like(g), g)

    def _set_gain_cols(self, L, C, mask):
        """Woodbury set gains from gathered columns C (G, S, d, m), mask
        (G, S, m).  Returns (G, S)."""
        m = C.shape[-1]
        P = self._minv_cols(L, C)                          # M⁻¹C
        K = self._eye(m) + self.isig2 * (C.mT @ P)
        K = K + torch.diag_embed(torch.where(mask, 0.0, 1.0))  # pin pads
        Z = _solve_lower(self._chol(K), P.mT)              # (G, S, m, d)
        return self.isig2 * torch.sum(Z * Z, dim=(-2, -1))

    def set_gain(self, state: AOptState, idx, mask):
        """f_S(R) per lane for idx/mask (G, *B, m); returns (G, *B): the
        column contract's ``dist_set_gain`` on the gathered columns."""
        return self.dist_set_gain(state, gather_columns(self.X, idx, mask),
                                  mask)

    def add_set(self, state: AOptState, idx, mask) -> AOptState:
        """State for S ∪ R per lane; idx/mask (G, m).  Re-adding a
        selected stimulus is a no-op (duplicates are masked out)."""
        lanes = idx.shape[0]
        new_mask = mask & ~torch.gather(state.sel_mask, 1, idx)
        C = gather_columns(self.X, idx, new_mask)          # (G, d, m)
        M = state.M + self.isig2 * (C @ C.mT)
        L = self._chol(M)
        sel = mark_selected(state.sel_mask, idx, mask)
        value = self.tr_prior - self._trace_inv(L)
        # The shared solve is refreshed once per state update, so gains()
        # and the filter engine read it for free.
        W = self._minv(L, self.X.expand(lanes, self.d, self.n))
        return AOptState(M=M, L=L, W=W.contiguous(), sel_mask=sel,
                         value=value)

    def add_one(self, state: AOptState, a) -> AOptState:
        """Add element a[g] to lane g; a: (G,) indices."""
        idx = torch.as_tensor(a, device=self.device).reshape(-1, 1).long()
        return self.add_set(state, idx, torch.ones_like(idx, dtype=torch.bool))

    # -- sample-batched filter engine (DASH inner loop) -------------------
    def expand_factors(self, state: AOptState, idx, mask):
        """Woodbury factors of the perturbed precision for S ∪ R_i.

        idx/mask (G, S, b).  With C = X_R (duplicates of S masked out, as
        in ``add_set``) and K = I + σ⁻² CᵀM⁻¹C = L_K L_Kᵀ:

            M_{S∪R}⁻¹ = M⁻¹ − E Eᵀ,   E = σ⁻¹ (M⁻¹C) L_K⁻ᵀ

        M⁻¹C is a column gather of the state's shared solve W, not a
        fresh pair of solves.  Returns E (G, S, d, b) and F = EᵀE
        (G, S, b, b); padded and duplicate slots give zero columns of E.
        """
        g, s, b = idx.shape
        flat = idx.reshape(g, s * b)
        new_mask = mask & ~torch.gather(state.sel_mask, 1, flat).reshape(
            g, s, b)
        C = gather_columns(self.X, idx, new_mask)          # (G, S, d, b)
        lanes = torch.arange(g, device=idx.device)[:, None]
        P = state.W.transpose(1, 2)[lanes, flat]           # (G, S·b, d)
        P = P.reshape(g, s, b, self.d).transpose(-1, -2)
        P = P * new_mask.to(P.dtype).unsqueeze(-2)
        return self._woodbury_factors(C, P)

    def _woodbury_factors(self, C, P):
        """(E, F) of M + σ⁻²CCᵀ given C and P = M⁻¹C (…, d, m)."""
        m = C.shape[-1]
        K = self._eye(m) + self.isig2 * (C.mT @ P)
        Et = math.sqrt(self.isig2) * _solve_lower(self._chol(K), P.mT)
        return Et.mT, Et @ Et.mT

    def filter_gains_batch(self, state: AOptState, idx, mask):
        """Gains w.r.t. S_g ∪ R_{g,i} for every lane and sample in one
        engine call.  idx/mask (G, S, b) → (G, S, n)."""
        E, F = self.expand_factors(state, idx, mask)
        g = aopt_filter_gains(self._x_stream(), state.W, E.contiguous(),
                              F.contiguous(), self.isig2,
                              precision=self.precision)
        s = idx.shape[1]
        sel = mark_selected(state.sel_mask[:, None, :].repeat(1, s, 1),
                            idx, mask)
        return torch.where(sel, torch.zeros_like(g), g)

    # -- distributed contract (column-based; see DistributedObjective) ----
    def dist_init(self, X_local, lanes: int = 1) -> AOptDistState:
        eye = self._eye(self.d)
        return AOptDistState(
            M=(self.beta2 * eye).repeat(lanes, 1, 1),
            L=(math.sqrt(self.beta2) * eye).repeat(lanes, 1, 1),
            W=(X_local / self.beta2).repeat(lanes, 1, 1),
        )

    def dist_value(self, ds: AOptDistState):
        return self.tr_prior - self._trace_inv(ds.L)

    def dist_gains(self, ds: AOptDistState, X_local):
        """(G, n_local): kernel 4 on the shard."""
        return aopt_gains(X_local, ds.W, self.isig2, precision=self.precision)

    def dist_set_gain(self, ds, C, mask):
        """Woodbury f_S(R) for gathered columns C (G, *B, d, m); returns
        (G, *B).  Reads only ``L``, which both state types carry."""
        lanes, batch, m = C.shape[0], C.shape[1:-2], C.shape[-1]
        C = C.reshape(lanes, -1, self.d, m)
        val = self._set_gain_cols(ds.L, C, mask.reshape(lanes, -1, m))
        return val.reshape(lanes, *batch)

    def dist_add_set(self, ds: AOptDistState, C, mask, X_local):
        """C (G, d, m), mask (G, m); refreshes the shard's W."""
        C = C * mask.to(C.dtype)[:, None, :]
        M = ds.M + self.isig2 * (C @ C.mT)
        L = self._chol(M)
        lanes, n_local = C.shape[0], X_local.shape[1]
        W = self._minv(L, X_local.expand(lanes, self.d, n_local))
        return AOptDistState(M=M, L=L, W=W.contiguous())

    def dist_filter_gains_batch(self, ds: AOptDistState, Cs, masks, X_local):
        """Cs (G, S, d, b), masks (G, S, b) → (G, S, n_local): kernel 5
        on the shard, with the factors of M_{S∪R_i}⁻¹ = M⁻¹ − E Eᵀ."""
        Cs = Cs * masks.to(Cs.dtype)[..., None, :]
        E, F = self._woodbury_factors(Cs, self._minv_cols(ds.L, Cs))
        return aopt_filter_gains(X_local, ds.W, E.contiguous(),
                                 F.contiguous(), self.isig2,
                                 precision=self.precision)

    # -- exact reference (tests) ------------------------------------------
    def brute_value(self, sel_idx):
        """f(S) for the index list ``sel_idx`` by an explicit inverse."""
        idx = torch.as_tensor(sel_idx, device=self.device).long()
        Xs = self.X[:, idx]
        M = self.beta2 * self._eye(self.d) + self.isig2 * (Xs @ Xs.T)
        return self.tr_prior - torch.trace(torch.linalg.inv(M))
