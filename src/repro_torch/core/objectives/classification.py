"""Feature selection for classification (paper §3.1, Corollary 8).

Ports the single-device half of ``repro/core/objectives/classification.py``
with an explicit lane axis (see ``base.py``).  Log-likelihood objective of
logistic regression on the support S:

    ℓ(w) = Σ_i y_i·(X_S w)_i − log(1 + e^{(X_S w)_i}),
    f(S) = ℓ(w^{(S)}) − ℓ(0)          (f(∅) = 0, at most d·ln 2)

* Singleton gains: per candidate a, ``newton_gain_steps`` scalar-Newton
  iterations on max_w ℓ(η_S + x_a·w) (``gain_mode="newton1d"``, the
  ``logistic_gains`` kernel, all lanes in one call); the first step is
  the Theorem-6 quadratic proxy g_a²/(2h_a) (``gain_mode="quadratic"``,
  ``torch.matmul``, as the reference leaves it to XLA).
* Set gains and state updates do a true refit: ``newton_steps`` damped
  IRLS iterations on the padded support (``newton_steps + 2`` in
  ``add_set`` and ``expand_logits``), batched over lanes and samples.
* Filter engine: each perturbed state S ∪ R_i is fully described by its
  refit logits η_i (``expand_logits``, the accept rule and step count of
  ``add_set``), so ``filter_gains_batch`` scores every lane's samples in
  one ``logistic_filter_gains`` call.

The two gain oracles go to the hand-written kernels whenever the
objective lives on the card — unlike the JAX reference, whose objective
defaults to its jnp references (``use_kernel=False``).  The IRLS refit
(Gram matrices, a Cholesky factorization and two triangular solves per
step) stays ``torch.matmul`` and ``torch.linalg``, as the reference
computes it outside any Pallas kernel; it keeps the reference's formulas
and issues no host sync (``cholesky_ex``; the step cap is a tensor op).

The ``dist_*`` methods are the sharded runtime's column-based contract
(``base.DistributedObjective``): the support stores its gathered columns
themselves (global indices mean nothing on a shard), the same on every
rank, so every refit is shard-independent; the sweeps run kernel 6 and
kernel 7 (on the refit logits) on the shard's columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.objectives.base import gather_columns, mark_selected
from repro_torch.kernels.common import (
    resolve_device,
    resolve_precision,
    set_full_f32_matmul,
    stream_dtype,
)
from repro_torch.kernels.filter_gains.ops import logistic_filter_gains
from repro_torch.kernels.logistic_gains.ops import logistic_gains
from repro_torch.kernels.logistic_gains.ref import softplus

GAIN_MODES = ("newton1d", "quadratic")


def _loglik(eta, y):
    """Σ_i y_i η_i − softplus(η_i) over the last axis."""
    return torch.sum(y * eta - softplus(eta), dim=-1)


class ClassificationState(NamedTuple):
    sel_idx: torch.Tensor    # (G, kcap) int64 — padded support indices
    sel_k: torch.Tensor      # (G, kcap) bool — which support slots are live
    w: torch.Tensor          # (G, kcap) f32 — weights on the support
    eta: torch.Tensor        # (G, d) current logits X_S w
    sel_mask: torch.Tensor   # (G, n) bool
    value: torch.Tensor      # (G,) f32 — ℓ(w^S) − ℓ(0)


class ClassificationDistState(NamedTuple):
    """The sharded runtime's support state, the same on every rank."""

    sup_cols: torch.Tensor   # (G, d, kcap) support columns, zero-padded
    sup_k: torch.Tensor      # (G, kcap) bool — live support slots
    w: torch.Tensor          # (G, kcap) f32 — weights on the support
    eta: torch.Tensor        # (G, d) current logits X_S w


class ClassificationObjective:
    """ℓ_class feature selection oracle.  X: (d, n), y: (d,) ∈ {0, 1}.

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path.  On the card it turns
    TF32 off for matmul and cuDNN: the reference is full f32.
    ``use_filter_engine=False`` sends DASH, FAST and adaptive sequencing
    through the per-sample ``gains(add_set(...))`` path.
    """

    def __init__(self, X, y, kmax: int, *, newton_steps: int = 6,
                 newton_gain_steps: int = 3, gain_mode: str = "newton1d",
                 ridge: float = 1e-4, gain_eps: float = 1e-9,
                 use_filter_engine: bool = True,
                 precision: str | None = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_full_f32_matmul()
        self.X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        self.X = self.X.contiguous()
        self.y = torch.as_tensor(y, dtype=torch.float32).to(self.device)
        self.d, self.n = self.X.shape
        self.kmax = int(kmax)
        self.newton_steps = int(newton_steps)
        self.newton_gain_steps = int(newton_gain_steps)
        if gain_mode not in GAIN_MODES:
            raise ValueError(f"gain_mode={gain_mode!r}; expected one of "
                             f"{GAIN_MODES}")
        self.gain_mode = gain_mode
        self.ridge = float(ridge)
        self.gain_eps = float(gain_eps)
        self.use_filter_engine = bool(use_filter_engine)
        # Streamed-operand policy of the newton1d kernel calls; the
        # quadratic mode is not kernel-backed and always runs f32.
        self.precision = resolve_precision(precision)
        self.ll0 = _loglik(torch.zeros_like(self.y), self.y)

    def _x_stream(self):
        """X in the streamed storage dtype, made once per precision view."""
        if getattr(self, "_xs", None) is None:
            self._xs = self.X.to(stream_dtype(self.precision))
        return self._xs

    # -- state ------------------------------------------------------------
    def init(self, lanes: int = 1) -> ClassificationState:
        dev = self.device
        return ClassificationState(
            sel_idx=torch.zeros((lanes, self.kmax), dtype=torch.int64,
                                device=dev),
            sel_k=torch.zeros((lanes, self.kmax), dtype=torch.bool,
                              device=dev),
            w=torch.zeros((lanes, self.kmax), device=dev),
            eta=torch.zeros((lanes, self.d), device=dev),
            sel_mask=torch.zeros((lanes, self.n), dtype=torch.bool,
                                 device=dev),
            value=torch.zeros((lanes,), device=dev),
        )

    def value(self, state: ClassificationState):
        return state.value

    # -- oracles ----------------------------------------------------------
    def _quadratic_gains(self, eta, X):
        """g²/(2h + eps) at logits eta (..., d) for the columns of X."""
        p = torch.sigmoid(eta)
        g = (self.y - p) @ X                           # (..., n)
        h = (p * (1.0 - p)) @ (X * X)
        return (g * g) / (2.0 * h + self.gain_eps)

    def _gains_cols(self, eta, Xs=None):
        """Per-candidate Newton (or quadratic) gains at logits eta (d,) or
        (G, d) for the columns ``Xs`` (all of X when None) — the one
        gain_mode dispatch behind the full sweep and the subset re-check."""
        if self.gain_mode == "quadratic":
            return self._quadratic_gains(eta, self.X if Xs is None else Xs)
        return logistic_gains(self._x_stream() if Xs is None else Xs, self.y,
                              eta, steps=self.newton_gain_steps,
                              precision=self.precision)

    def gains(self, state: ClassificationState):
        """(G, n) singleton gains, one kernel call for all lanes."""
        g = self._gains_cols(state.eta)
        return torch.where(state.sel_mask, torch.zeros_like(g), g)

    def gains_subset(self, state: ClassificationState, idx):
        """(G, B) singleton gains for the candidate subsets idx (G, B) —
        the sweep over the gathered columns, one call per lane."""
        g = torch.stack([
            self._gains_cols(state.eta[i], self.X[:, idx[i]].contiguous())
            for i in range(idx.shape[0])
        ])
        sel = torch.gather(state.sel_mask, 1, idx)
        return torch.where(sel, torch.zeros_like(g), g)

    def _refit(self, cols, mask, w0, steps: int):
        """Damped IRLS on fixed padded supports, batched over the leading
        axes: cols (..., d, m), mask and w0 (..., m).  Returns
        (w, eta, ll)."""
        maskf = mask.to(cols.dtype)
        pin = torch.diag_embed(torch.where(
            mask, torch.full_like(maskf, self.ridge), torch.ones_like(maskf)))
        w = w0
        eta = (cols @ w0.unsqueeze(-1)).squeeze(-1)
        for _ in range(steps):
            p = torch.sigmoid(eta)
            grad = (cols.mT @ (self.y - p).unsqueeze(-1)).squeeze(-1) * maskf
            wgt = p * (1.0 - p) + 1e-6
            G = cols.mT @ (cols * wgt.unsqueeze(-1)) + pin
            # cholesky_ex: no host sync; G is PD (ridge + 1e-6 weights).
            L = torch.linalg.cholesky_ex(G).L
            z = torch.linalg.solve_triangular(L, grad.unsqueeze(-1),
                                              upper=False)
            delta = torch.linalg.solve_triangular(L.mT, z, upper=True)
            delta = delta.squeeze(-1) * maskf
            # Damped step: cap ‖Δη‖∞ to keep IRLS stable far from optimum.
            deta = (cols @ delta.unsqueeze(-1)).squeeze(-1)
            big = torch.clamp(torch.amax(torch.abs(deta), dim=-1), min=1e-9)
            scale = torch.clamp(4.0 / big, max=1.0).unsqueeze(-1)
            w = w + scale * delta
            eta = eta + scale * deta
        return w, eta, _loglik(eta, self.y)

    def _union(self, state, idx, take):
        """Padded supports S_g ∪ R for idx/take (G, S, m): indices and
        mask (G, S, kcap + m), S's slots first."""
        g, s, _ = idx.shape
        sup_idx = torch.cat([state.sel_idx[:, None].expand(g, s, -1), idx],
                            dim=-1)
        sup_mask = torch.cat([state.sel_k[:, None].expand(g, s, -1), take],
                             dim=-1)
        return sup_idx, sup_mask

    def _new_mask(self, state, idx, mask):
        """mask & (not already in S_g), for idx/mask (G, S, m)."""
        g, s, m = idx.shape
        in_s = torch.gather(state.sel_mask, 1, idx.reshape(g, s * m))
        return mask & ~in_s.reshape(g, s, m)

    def set_gain(self, state: ClassificationState, idx, mask):
        """f_S(R) per lane for idx/mask (G, *B, m); returns (G, *B).  No
        capacity cut: the support is kcap + m slots."""
        lanes, batch, m = idx.shape[0], idx.shape[1:-1], idx.shape[-1]
        idx3 = idx.reshape(lanes, -1, m)
        new = self._new_mask(state, idx3, mask.reshape(lanes, -1, m))
        sup_idx, sup_mask = self._union(state, idx3, new)
        cols = gather_columns(self.X, sup_idx, sup_mask)
        w0 = torch.cat([state.w[:, None].expand(-1, idx3.shape[1], -1),
                        torch.zeros(new.shape, device=self.device)], dim=-1)
        gain = self._support_gain(cols, sup_mask, w0,
                                  state.value + self.ll0)
        return gain.reshape(lanes, *batch)

    def _support_gain(self, cols, sup_mask, w0, ll_s):
        """max(ℓ(S ∪ R) − ℓ(S), 0) from the refit on the padded supports
        (G, S, d, ·) of ``set_gain`` and ``dist_set_gain``; ``ll_s``
        (G,) is each lane's ℓ(S)."""
        _, _, ll = self._refit(cols, sup_mask, w0, self.newton_steps)
        return torch.clamp(ll - ll_s[:, None], min=0.0)

    def _accept(self, state, new):
        """The accept rule of ``add_set`` in cumsum form: dedup against S
        (``new``), then capacity in slot order — element j is taken iff
        the count after the earlier accepted elements is still < kmax.
        new (G, S, m); returns (take, order)."""
        cnt0 = torch.sum(state.sel_k.to(torch.int64), dim=-1)
        order = torch.cumsum(new.to(torch.int64), dim=-1)
        take = new & (cnt0[:, None, None] + order <= self.kmax)
        return take, cnt0[:, None, None] + order - 1

    def add_set(self, state: ClassificationState, idx,
                mask) -> ClassificationState:
        """State for S ∪ R per lane; idx/mask (G, m).  Accepted elements
        append to the support in slot order; duplicates of S are skipped
        and elements past kmax dropped (the reference's slot loop)."""
        g = idx.shape[0]
        new = self._new_mask(state, idx[:, None], mask[:, None])
        take, slot = self._accept(state, new)
        take, slot = take[:, 0], slot[:, 0]
        # Rejected elements write to a spare slot that is dropped.
        slot = torch.where(take, slot, torch.full_like(slot, self.kmax))
        spare = torch.zeros((g, 1), dtype=torch.int64, device=self.device)
        sel_idx = torch.cat([state.sel_idx, spare], dim=1).scatter(
            1, slot, idx)[:, :self.kmax]
        sel_k = torch.cat([state.sel_k, spare.bool()], dim=1).scatter(
            1, slot, take)[:, :self.kmax] | state.sel_k
        cols = gather_columns(self.X, sel_idx, sel_k)
        # Warm start: previous weights on previous slots (slots only append).
        w0 = state.w * state.sel_k
        w, eta, ll = self._refit(cols, sel_k, w0, self.newton_steps + 2)
        return ClassificationState(
            sel_idx=sel_idx, sel_k=sel_k, w=w, eta=eta,
            sel_mask=mark_selected(state.sel_mask, idx, mask),
            value=ll - self.ll0,
        )

    def add_one(self, state: ClassificationState, a) -> ClassificationState:
        """Add element a[g] to lane g; a: (G,) indices."""
        idx = torch.as_tensor(a, device=self.device).reshape(-1, 1).long()
        return self.add_set(state, idx, torch.ones_like(idx, dtype=torch.bool))

    # -- sample-batched filter engine (DASH inner loop) -------------------
    def expand_logits(self, state: ClassificationState, idx, mask):
        """Refit logits η for every S_g ∪ R_gi without committing the
        state: ``add_set``'s accept rule on the concatenated padded
        support, warm-started from the current weights, ``newton_steps
        + 2`` IRLS iterations.  idx/mask (G, S, m) → (G, S, d)."""
        new = self._new_mask(state, idx, mask)
        take, _ = self._accept(state, new)
        sup_idx, sup_mask = self._union(state, idx, take)
        cols = gather_columns(self.X, sup_idx, sup_mask)
        w_s = (state.w * state.sel_k)[:, None].expand(-1, idx.shape[1], -1)
        w0 = torch.cat([w_s, torch.zeros(take.shape, device=self.device)],
                       dim=-1)
        _, eta, _ = self._refit(cols, sup_mask, w0, self.newton_steps + 2)
        return eta

    def filter_gains_batch(self, state: ClassificationState, idx, mask):
        """Gains w.r.t. S_g ∪ R_{g,i} for every lane and sample in one
        engine call.  idx/mask (G, S, m) → (G, S, n)."""
        etas = self.expand_logits(state, idx, mask)
        if self.gain_mode == "quadratic":
            g = self._quadratic_gains(etas, self.X)
        else:
            g = logistic_filter_gains(self._x_stream(), self.y,
                                      etas.contiguous(),
                                      steps=self.newton_gain_steps,
                                      precision=self.precision)
        s = idx.shape[1]
        sel = mark_selected(state.sel_mask[:, None, :].repeat(1, s, 1),
                            idx, mask)
        return torch.where(sel, torch.zeros_like(g), g)

    # -- distributed contract (column-based; see DistributedObjective) ----
    def dist_init(self, X_local, lanes: int = 1) -> ClassificationDistState:
        dev = self.device
        return ClassificationDistState(
            sup_cols=torch.zeros((lanes, self.d, self.kmax), device=dev),
            sup_k=torch.zeros((lanes, self.kmax), dtype=torch.bool,
                              device=dev),
            w=torch.zeros((lanes, self.kmax), device=dev),
            eta=torch.zeros((lanes, self.d), device=dev),
        )

    def dist_value(self, ds: ClassificationDistState):
        return _loglik(ds.eta, self.y) - self.ll0

    def dist_gains(self, ds: ClassificationDistState, X_local):
        """(G, n_local): kernel 6 on the shard (or the quadratic proxy)."""
        if self.gain_mode == "quadratic":
            return self._quadratic_gains(ds.eta, X_local)
        return logistic_gains(X_local, self.y, ds.eta,
                              steps=self.newton_gain_steps,
                              precision=self.precision)

    def _dist_union(self, ds, C, take):
        """Supports S ∪ R from gathered columns C (G, S, d, m) and their
        accepted slots ``take`` (G, S, m): columns, mask and warm start
        (G, S, ·, kcap + m), S's slots first."""
        g, s = C.shape[:2]
        sup_cols = torch.cat([ds.sup_cols[:, None].expand(g, s, -1, -1),
                              C * take.to(C.dtype).unsqueeze(-2)], dim=-1)
        sup_mask = torch.cat([ds.sup_k[:, None].expand(g, s, -1), take],
                             dim=-1)
        w_s = (ds.w * ds.sup_k)[:, None].expand(g, s, -1)
        w0 = torch.cat([w_s, torch.zeros(take.shape, device=self.device)],
                       dim=-1)
        return sup_cols, sup_mask, w0

    def dist_set_gain(self, ds: ClassificationDistState, C, mask):
        """f_S(R) for gathered columns C (G, *B, d, m); returns (G, *B).
        No capacity cut: the support is kcap + m slots."""
        lanes, batch, m = C.shape[0], C.shape[1:-2], C.shape[-1]
        C = C.reshape(lanes, -1, self.d, m)
        mask = mask.reshape(lanes, -1, m)
        take = mask & (torch.sum(C * C, dim=-2) > 0)
        gain = self._support_gain(*self._dist_union(ds, C, take),
                                  _loglik(ds.eta, self.y))
        return gain.reshape(lanes, *batch)

    def dist_add_set(self, ds: ClassificationDistState, C, mask, X_local):
        """C (G, d, m), mask (G, m).  Accepted columns append to the
        support in slot order; zero (padding) columns are never accepted
        and elements past kmax are dropped (the reference's slot loop)."""
        take = mask & (torch.sum(C * C, dim=-2) > 0)
        cnt0 = torch.sum(ds.sup_k.to(torch.int64), dim=-1)
        order = torch.cumsum(take.to(torch.int64), dim=-1)
        take = take & (cnt0[:, None] + order <= self.kmax)
        # Rejected columns write to a spare slot that is dropped.
        slot = torch.where(take, cnt0[:, None] + order - 1,
                           torch.full_like(order, self.kmax))
        g = C.shape[0]
        spare = torch.zeros((g, self.d, 1), device=self.device)
        sup_cols = torch.cat([ds.sup_cols, spare], dim=-1).scatter(
            2, slot[:, None, :].expand(-1, self.d, -1),
            C)[..., :self.kmax]
        sup_k = torch.cat([ds.sup_k, spare[:, 0].bool()], dim=1).scatter(
            1, slot, take)[:, :self.kmax] | ds.sup_k
        w, eta, _ = self._refit(sup_cols, sup_k, ds.w * ds.sup_k,
                                self.newton_steps + 2)
        return ClassificationDistState(sup_cols=sup_cols, sup_k=sup_k, w=w,
                                       eta=eta)

    def _dist_expand_logits(self, ds: ClassificationDistState, Cs, masks):
        """Refit logits for every S_g ∪ R_gi from gathered columns (the
        accept rule and step count of ``dist_add_set``, uncommitted);
        Cs (G, S, d, m) → (G, S, d)."""
        new = masks & (torch.sum(Cs * Cs, dim=-2) > 0)
        cnt0 = torch.sum(ds.sup_k.to(torch.int64), dim=-1)
        order = torch.cumsum(new.to(torch.int64), dim=-1)
        take = new & (cnt0[:, None, None] + order <= self.kmax)
        _, eta, _ = self._refit(*self._dist_union(ds, Cs, take),
                                self.newton_steps + 2)
        return eta

    def dist_filter_gains_batch(self, ds: ClassificationDistState, Cs,
                                masks, X_local):
        """Cs (G, S, d, m), masks (G, S, m) → (G, S, n_local): kernel 7
        on the shard, at every sample's refit logits."""
        etas = self._dist_expand_logits(ds, Cs, masks)
        if self.gain_mode == "quadratic":
            return self._quadratic_gains(etas, X_local)
        return logistic_filter_gains(X_local, self.y, etas.contiguous(),
                                     steps=self.newton_gain_steps,
                                     precision=self.precision)

    # -- exact reference (tests) ------------------------------------------
    def brute_value(self, sel_idx, steps: int = 60):
        """f(S) for the index list ``sel_idx`` by a long refit from 0."""
        idx = torch.as_tensor(sel_idx, device=self.device).long()
        m = idx.shape[0]
        ones = torch.ones((m,), dtype=torch.bool, device=self.device)
        _, _, ll = self._refit(self.X[:, idx], ones,
                               torch.zeros((m,), device=self.device), steps)
        return ll - self.ll0
