"""Feature selection for linear regression (paper §3.1, Corollary 7).

Ports the single-device half of ``repro/core/objectives/regression.py``
with an explicit lane axis (see ``base.py``).  Normalized objective

    f(S) = ‖proj_{span(X_S)} y‖² / ‖y‖²

kept through an orthonormal basis Q of span(X_S) (incremental modified
Gram–Schmidt) and the residual r = y − QQᵀy:

    f_S(a) = (x_aᵀ r)² / (‖x_a‖² − ‖Qᵀ x_a‖²)          (singleton gains)
    f_S(R) = bᵀ G⁻¹ b,  C̃ = (I−QQᵀ) X_R, G = C̃ᵀC̃, b = C̃ᵀ r

The singleton sweep and DASH's sample-batched filter statistic go to the
hand-written kernels whenever the objective lives on the card — unlike
the JAX reference, whose objective defaults to its jnp references.  The
small products of MGS and the batched Cholesky stay ``torch.matmul`` and
``torch.linalg``, as the reference leaves them to XLA.

The ``dist_*`` methods are the sharded runtime's column-based contract
(``base.DistributedObjective``): the basis, its count and the residual
are the same on every rank, the column norms are the shard's, and the
sweeps run kernels 1 and 3 on the shard's columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.objectives.base import (
    gather_columns,
    mark_selected,
    write_accepted_column,
)
from repro_torch.kernels.common import (
    by_column_blocks,
    resolve_device,
    resolve_precision,
    set_full_f32_matmul,
    stream_dtype,
)
from repro_torch.kernels.filter_gains.ops import filter_gains
from repro_torch.kernels.marginal_gains.ops import regression_gains


def column_sq_norms(X: torch.Tensor) -> torch.Tensor:
    """(n,) ‖x_a‖², on the CPU each column summed in an order fixed by d,
    so that a shard's norms are the whole X's bits."""
    return by_column_blocks(lambda Xb: torch.sum(Xb * Xb, dim=0), X)


class RegressionState(NamedTuple):
    Q: torch.Tensor          # (G, d, kcap) orthonormal basis, zero-padded
    count: torch.Tensor      # (G,) int32 — number of basis vectors
    resid: torch.Tensor      # (G, d) residual y − QQᵀy
    sel_mask: torch.Tensor   # (G, n) bool
    value: torch.Tensor      # (G,) f32 — normalized f(S)


class RegressionDistState(NamedTuple):
    """The sharded runtime's state: no ``sel_mask`` (the runner keeps the
    shard's), ``col_sq`` the shard's column norms."""

    Q: torch.Tensor          # (G, d, kcap) orthonormal basis — replicated
    count: torch.Tensor      # (G,) int32 — replicated
    resid: torch.Tensor      # (G, d) — replicated
    col_sq: torch.Tensor     # (n_local,) — the shard's


def _project_shared(Q, V):
    """Q Qᵀ v for every row v of V: Q (G, d, k) shared by the S rows of
    V (G, S, d).  Returns (G, S, d)."""
    return (Q @ (Q.transpose(-1, -2) @ V.transpose(-1, -2))).transpose(-1, -2)


def _project_own(D, V):
    """D_s D_sᵀ v_s with one basis per row: D (G, S, d, m), V (G, S, d)."""
    return (D @ (D.transpose(-1, -2) @ V.unsqueeze(-1))).squeeze(-1)


def _accept(v0, v, span_tol: float, room):
    """The MGS accept rule: a nonzero column, out of span, with room."""
    nrm0 = torch.sqrt(torch.sum(v0 * v0, dim=-1))
    nrm = torch.sqrt(torch.sum(v * v, dim=-1))
    accept = (nrm0 > 0) & (nrm > span_tol * torch.clamp(nrm0, min=1.0)) & room
    q = torch.where(accept[..., None],
                    v / torch.clamp(nrm, min=1e-30)[..., None],
                    torch.zeros_like(v))
    return accept, q


def mgs_extend(Q, count, resid, C, kmax: int, span_tol: float = 1e-6):
    """Commit the columns of C into the orthonormal basis Q, per lane.

    Q (L, d, k), count (L,), resid (L, d), C (L, d, m).  Each column is
    MGS-orthonormalized (two projection rounds) and appended at slot
    ``count``.  Rejected columns — zero/padded, numerically in span, or
    at capacity — leave Q, count and resid untouched; the write into the
    last slot is guarded so an at-capacity call cannot clobber the basis
    vector stored there.  Returns new ``(Q, count, resid)``; the inputs
    are not modified.
    """
    Q = Q.clone()
    for j in range(C.shape[-1]):
        v0 = C[..., j]
        v = v0 - _project_shared(Q, v0[:, None, :])[:, 0]
        v = v - _project_shared(Q, v[:, None, :])[:, 0]
        accept, q = _accept(v0, v, span_tol, count < kmax)
        write_accepted_column(Q, torch.clamp(count, max=kmax - 1), accept, q)
        resid = resid - q * torch.sum(q * resid, dim=-1, keepdim=True)
        count = count + accept.to(torch.int32)
    return Q, count, resid


def mgs_expand(Q, count, resid, C, kmax: int, span_tol: float = 1e-6):
    """MGS deltas for S ∪ R without rewriting the shared basis.

    Q (G, d, k), count (G,), resid (G, d) per lane; C (G, S, d, m): S
    sample sets per lane.  The accept rule of :func:`mgs_extend`
    (projections against Q and the earlier deltas, two rounds), but
    accepted columns land in fresh buffers D (G, S, d, m) ⊥ span(Q).
    Returns ``(D, resid)`` — per-sample delta bases and residuals.
    """
    g, s, d, m = C.shape
    D = torch.zeros((g, s, d, m), dtype=torch.float32, device=C.device)
    flat = D.view(g * s, d, m)
    dcount = torch.zeros((g, s), dtype=torch.int32, device=C.device)
    r = resid[:, None, :].repeat(1, s, 1)
    for j in range(m):
        v0 = C[..., j]
        v = v0 - _project_shared(Q, v0)
        v = v - _project_own(D, v)
        v = v - _project_shared(Q, v)
        v = v - _project_own(D, v)
        accept, q = _accept(v0, v, span_tol, count[:, None] + dcount < kmax)
        write_accepted_column(flat, torch.clamp(dcount, max=m - 1).reshape(-1),
                              accept.reshape(-1), q.reshape(g * s, d))
        r = r - q * torch.sum(q * r, dim=-1, keepdim=True)
        dcount = dcount + accept.to(torch.int32)
    return D, r


class RegressionObjective:
    """ℓ_reg feature selection oracle.  X: (d, n) columns, y: (d,).

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path.  On the card it turns
    TF32 off for matmul and cuDNN: the reference is full f32.
    ``use_filter_engine=False`` sends DASH, FAST and adaptive sequencing
    through the per-sample ``gains(add_set(...))`` path.
    """

    def __init__(self, X, y, kmax: int, *, span_tol: float = 1e-6,
                 jitter: float = 1e-8, use_filter_engine: bool = True,
                 precision: str | None = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_full_f32_matmul()
        self.X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        self.X = self.X.contiguous()
        self.y = torch.as_tensor(y, dtype=torch.float32).to(self.device)
        self.d, self.n = self.X.shape
        self.kmax = int(kmax)
        self.span_tol = float(span_tol)
        self.jitter = float(jitter)
        self.use_filter_engine = bool(use_filter_engine)
        self.precision = resolve_precision(precision)
        self.ysq = torch.clamp(torch.sum(self.y * self.y), min=1e-12)
        self.col_sq = column_sq_norms(self.X)

    def _x_stream(self):
        """X in the streamed storage dtype, made once per precision view."""
        if getattr(self, "_xs", None) is None:
            self._xs = self.X.to(stream_dtype(self.precision))
        return self._xs

    # -- state ------------------------------------------------------------
    def init(self, lanes: int = 1) -> RegressionState:
        dev = self.device
        return RegressionState(
            Q=torch.zeros((lanes, self.d, self.kmax), device=dev),
            count=torch.zeros((lanes,), dtype=torch.int32, device=dev),
            resid=self.y.repeat(lanes, 1),
            sel_mask=torch.zeros((lanes, self.n), dtype=torch.bool,
                                 device=dev),
            value=torch.zeros((lanes,), device=dev),
        )

    def value(self, state: RegressionState):
        return state.value

    # -- oracles ----------------------------------------------------------
    def gains(self, state: RegressionState):
        """(G, n) normalized singleton gains, one kernel call for all
        lanes."""
        g = regression_gains(self._x_stream(), state.Q, state.resid,
                             self.col_sq, precision=self.precision)
        g = g / self.ysq
        return torch.where(state.sel_mask, torch.zeros_like(g), g)

    def gains_subset(self, state: RegressionState, idx):
        """(G, B) singleton gains for the candidate subsets idx (G, B) —
        the same sweep over the gathered columns, one call per lane."""
        rows = []
        for g in range(idx.shape[0]):
            cols = idx[g]
            rows.append(regression_gains(
                self.X[:, cols].contiguous(), state.Q[g], state.resid[g],
                self.col_sq[cols], precision=self.precision) / self.ysq)
        g = torch.stack(rows)
        sel = torch.gather(state.sel_mask, 1, idx)
        return torch.where(sel, torch.zeros_like(g), g)

    def set_gain(self, state: RegressionState, idx, mask):
        """f_S(R) per lane for idx/mask (G, *B, m); returns (G, *B): the
        column contract's ``dist_set_gain`` on the gathered columns."""
        return self.dist_set_gain(state, gather_columns(self.X, idx, mask),
                                  mask)

    def add_set(self, state: RegressionState, idx, mask) -> RegressionState:
        """State for S ∪ R per lane; idx/mask (G, m)."""
        C = gather_columns(self.X, idx, mask)              # (G, d, m)
        Q, count, resid = mgs_extend(state.Q, state.count, state.resid, C,
                                     self.kmax, self.span_tol)
        sel = mark_selected(state.sel_mask, idx, mask)
        value = (self.ysq - torch.sum(resid * resid, dim=-1)) / self.ysq
        return RegressionState(Q=Q, count=count, resid=resid, sel_mask=sel,
                               value=value)

    def add_one(self, state: RegressionState, a) -> RegressionState:
        """Add element a[g] to lane g; a: (G,) indices."""
        idx = torch.as_tensor(a, device=self.device).reshape(-1, 1).long()
        return self.add_set(state, idx, torch.ones_like(idx, dtype=torch.bool))

    # -- sample-batched filter engine (DASH inner loop) -------------------
    def expand_basis(self, state: RegressionState, idx, mask):
        """MGS deltas for S ∪ R_i without rewriting the shared basis.

        idx/mask (G, S, m).  Returns (D (G, S, d, m), R (G, S, d))."""
        C = gather_columns(self.X, idx, mask)              # (G, S, d, m)
        return mgs_expand(state.Q, state.count, state.resid, C, self.kmax,
                          self.span_tol)

    def filter_gains_batch(self, state: RegressionState, idx, mask):
        """Gains w.r.t. S_g ∪ R_{g,i} for every lane and sample in one
        engine call.  idx/mask (G, S, m) → (G, S, n)."""
        D, R = self.expand_basis(state, idx, mask)
        g = filter_gains(self._x_stream(), state.Q, D, R, self.col_sq,
                         precision=self.precision) / self.ysq
        s = idx.shape[1]
        sel = mark_selected(state.sel_mask[:, None, :].repeat(1, s, 1),
                            idx, mask)
        return torch.where(sel, torch.zeros_like(g), g)

    # -- distributed contract (column-based; see DistributedObjective) ----
    def dist_init(self, X_local, lanes: int = 1) -> RegressionDistState:
        return RegressionDistState(
            Q=torch.zeros((lanes, self.d, self.kmax), device=self.device),
            count=torch.zeros((lanes,), dtype=torch.int32,
                              device=self.device),
            resid=self.y.repeat(lanes, 1),
            col_sq=column_sq_norms(X_local),
        )

    def dist_value(self, ds: RegressionDistState):
        return (self.ysq - torch.sum(ds.resid * ds.resid, dim=-1)) / self.ysq

    def dist_gains(self, ds: RegressionDistState, X_local):
        """(G, n_local): kernel 1 on the shard."""
        return regression_gains(X_local, ds.Q, ds.resid, ds.col_sq,
                                precision=self.precision) / self.ysq

    def dist_set_gain(self, ds, C, mask):
        """f_S(R) for gathered columns C (G, *B, d, m); returns (G, *B).
        Reads only ``Q`` and ``resid``, which both state types carry."""
        lanes, batch, m = C.shape[0], C.shape[1:-2], C.shape[-1]
        C = C.reshape(lanes, -1, self.d, m)
        mask = mask.reshape(lanes, -1, m)
        s = C.shape[1]
        Cm = C.permute(0, 2, 1, 3).reshape(lanes, self.d, s * m)
        P = ds.Q @ (ds.Q.transpose(-1, -2) @ Cm)
        Ct = C - P.reshape(lanes, self.d, s, m).permute(0, 2, 1, 3)
        csq = torch.sum(C * C, dim=-2)
        G = Ct.transpose(-1, -2) @ Ct
        # Padded/in-span columns: pin the diagonal so Cholesky stays PD.
        diag_fix = torch.where(mask & (csq > 0),
                               self.jitter * torch.clamp(csq, min=1.0),
                               torch.ones_like(csq))
        G = G + torch.diag_embed(diag_fix)
        b = (Ct.transpose(-1, -2) @ ds.resid[:, None, :, None])[..., 0]
        b = b * mask
        L, info = torch.linalg.cholesky_ex(G)
        z = torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]
        val = torch.sum(z * z, dim=-1) / self.ysq
        # A failed factorization gives NaN, as jnp.linalg.cholesky does.
        val = torch.where(info == 0, val, torch.full_like(val, torch.nan))
        return val.reshape(lanes, *batch)

    def dist_add_set(self, ds: RegressionDistState, C, mask, X_local):
        """C (G, d, m), mask (G, m)."""
        C = C * mask.to(C.dtype)[:, None, :]
        Q, count, resid = mgs_extend(ds.Q, ds.count, ds.resid, C, self.kmax,
                                     self.span_tol)
        return ds._replace(Q=Q, count=count, resid=resid)

    def dist_filter_gains_batch(self, ds: RegressionDistState, Cs, masks,
                                X_local):
        """Cs (G, S, d, m), masks (G, S, m) → (G, S, n_local): kernel 3 on
        the shard."""
        Cs = Cs * masks.to(Cs.dtype)[..., None, :]
        D, R = mgs_expand(ds.Q, ds.count, ds.resid, Cs, self.kmax,
                          self.span_tol)
        return filter_gains(X_local, ds.Q, D, R, ds.col_sq,
                            precision=self.precision) / self.ysq

    # -- exact reference (tests) ------------------------------------------
    def brute_value(self, sel_idx):
        """f(S) for the index list ``sel_idx`` by a full least-squares
        solve: the oracle of the property tests."""
        Xs = self.X[:, torch.as_tensor(sel_idx, device=self.device).long()]
        w = torch.linalg.lstsq(Xs, self.y[:, None]).solution[:, 0]
        resid = self.y - Xs @ w
        return (self.ysq - torch.sum(resid * resid)) / self.ysq
