"""The port's train step against the JAX reference on the CPU: three
steps of reduced smollm-135m from the reference's initial state, carried
in with ``repro_torch.convert.train_state_from_numpy``, at one and two
microbatches and with both gradient-compression schemes.

Each step's metrics (loss, lm_loss, aux_loss, grad_norm, lr) and the
state after it (parameters, AdamW's step, master, m and v, the error
feedback) are held against the reference's after the same step on the
same batch (4 × 32 tokens, seeded numpy).

Tolerances, from readings on the CPU:
  * METRIC_RTOL 2e-6 — loss, lm_loss and grad_norm; the learning rate
    to LR_RTOL 1e-6 (the f32 cosine);
  * STATE_TOL — each state tree's largest |port − reference| over its
    largest entry: m and the error feedback carry the gradients'
    agreement (``tests/test_torch_train_loss.py``'s GRAD_TOL 1e-5;
    readings at most 1.1e-6 and 2.3e-6), v its square (1.1e-6); int8's
    feedback at INT8_EF_TOL (below);
  * STEP_TOL 1e-3 — the master and the parameters move by about the
    learning rate times ±1 a step (Adam's first steps are g/|g|), so
    their differences are read in units of the learning rate: readings
    at most 1.9e-4.
A planted fault, the learning rate 1 % high in the port's step, reads
above the parameters' tolerance.

Compression makes discrete decisions (int8's rounding, top-k's mask),
so the ROADMAP's rule for randomized algorithms applies: the states
agree within the tolerances up to the first decision that the two
packages part on, and that decision's margin must lie within what the
gradients' agreement allows (DECISION_MARGIN, in the decision's units:
the int8 quotient's distance to its rounding boundary, the top-k
entry's distance to the threshold over the largest entry).  Before each
compressed step both packages' compressor inputs (gradient plus error
feedback, in the reference's stacked leaves) are rebuilt and their
decisions compared.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import compress_gradients as jax_compress  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim import decompress_gradients as jax_decompress  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _split_params,
    train_state_from_numpy,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    loss_and_grads,
    make_train_step,
    stack_layers,
)

METRIC_RTOL = 2e-6
LR_RTOL = 1e-6
STATE_TOL = {"m": 1e-5, "v": 2e-5, "error_fb": 1e-5}
# int8's error feedback g − q·scale is at most scale / 2 = max|g| / 254,
# so a 1e-6 relative difference of the scale reads 254 times larger
# against the feedback's own largest entry (reading 2.5e-4).
INT8_EF_TOL = 1e-3
STEP_TOL = 1e-3      # master and params: |Δ| over the learning rate
ARCH = "smollm-135m"
CASES = [dict(), dict(microbatches=2), dict(grad_compression="topk"),
         dict(grad_compression="int8")]
CPU = torch.device("cpu")
# The port's step on the reference's own gradients: compression and
# AdamW alone, where nothing parts the decisions.  m, v and the error
# feedback to 5e-6 of their largest entries (readings up to 9.0e-7: the
# clipping scale's global norm sums in another order); the master and
# the parameters to 1e-4 of the learning rate (readings 1.5e-5: Adam's
# early g/|g| passes that scale's ulp on amplified where |g| is small).
SAME_GRADS_TOL = 5e-6
SAME_GRADS_STEP_TOL = 1e-4


def _batches(cfg, n, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)} for _ in range(n)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_err(got, want, scale=None):
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    err = max(float((g.to(torch.float32) - w.to(torch.float32)).abs().max())
              for g, w in zip(gl, wl))
    if scale is None:
        scale = max(float(w.abs().max()) for w in wl)
    return err / scale


# The gradients agree to GRAD_TOL 1e-5 of their largest entry: an int8
# quotient (127 · x / max|x|) to 127e-5, a top-k entry to 1e-5 of the
# largest (twice, with the threshold's own error).
DECISION_MARGIN = {"int8": 127 * 1e-5, "topk": 2e-5}


def _decisions(x, scheme):
    """(decision, margin) of one compressor input leaf (f32 numpy)."""
    flat = x.reshape(-1)
    if scheme == "int8":
        r = x / (max(np.abs(flat).max(), 1e-12) / 127.0)
        return np.round(r), np.abs(np.abs(r - np.floor(r)) - 0.5)
    k = max(1, int(flat.size * 0.05))
    thresh = np.sort(np.abs(flat))[-k]
    return (np.abs(x) >= thresh,
            np.abs(np.abs(x) - thresh) / np.abs(flat).max())


def parted_decision(jm, jstate, tm, tstate, batch, scheme):
    """None when every compression decision of this step agrees, else
    the largest margin among the parted ones."""
    g = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        jstate.params, {"tokens": jnp.asarray(batch["tokens"])})
    xj = jax.tree_util.tree_map(
        lambda a, e: np.asarray(a, np.float32) + np.asarray(e), g,
        jstate.error_fb)
    _, _, tg = loss_and_grads(tm, tstate.params,
                              {"tokens": torch.from_numpy(batch["tokens"])})
    period = tm.cfg.pattern_period

    def ref_layout(tree):          # the reference's key for the layers
        st = stack_layers(tree, period)
        st["blocks"] = st.pop("layers")
        return tree_leaves(st)

    xt = [(a.to(torch.float32) + e).numpy() for a, e in zip(
        ref_layout(tg), ref_layout(tstate.error_fb))]
    worst = None
    for a, b in zip(jax.tree_util.tree_leaves(xj), xt):
        dj, mj = _decisions(a, scheme)
        dt, _ = _decisions(b, scheme)
        parted = dj != dt
        if parted.any():
            worst = max(worst or 0.0, float(mj[parted].max()))
    return worst


def jax_step_on(jstate, grads, jt):
    """The reference train step's part after its gradients, on
    ``grads``: compression with error feedback, then AdamW."""
    lr = jax_cosine(jstate.opt.step, base_lr=jt.learning_rate,
                    warmup_steps=jt.warmup_steps,
                    total_steps=jt.total_steps)
    grads = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads)
    comp, ef = jax_compress(grads, jstate.error_fb, jt.grad_compression)
    grads = jax_decompress(comp, jt.grad_compression)
    params, opt, om = jax_adamw_update(grads, jstate.opt, lr, jt,
                                       param_dtype=jnp.float32)
    return (jstate._replace(params=params, opt=opt, error_fb=ef),
            {**om, "lr": lr})


def run_both(tcfg_kw, steps=3, lr_scale=1.0, same_grads=False):
    """(reference metrics, port metrics, reference states as port trees,
    port states) after each of ``steps`` steps, up to the step before
    the first parted compression decision."""
    kw = dict(total_steps=10, learning_rate=2e-3, warmup_steps=1, **tcfg_kw)
    jcfg = jax_reduced_config(ARCH)
    jm = jax_build_model(jcfg)
    jt = JaxTrainConfig(**kw)
    jstate = jax_init_state(jm, jax.random.PRNGKey(0), jt)
    cfg = get_reduced_config(ARCH)
    tm = build_model(cfg)
    tstate = train_state_from_numpy(cfg, _np_tree(jstate), "cpu")
    tt = TrainConfig(**dict(kw, learning_rate=kw["learning_rate"]
                            * lr_scale))
    jstep = jax.jit(jax_make_step(jm, jt))
    tstep = make_train_step(tm, tt)
    jgrad = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    out = []
    scheme = tcfg_kw.get("grad_compression", "none")
    for batch in _batches(cfg, steps):
        if same_grads:
            (jl, jmet), g = jgrad(jstate.params,
                                  {"tokens": jnp.asarray(batch["tokens"])})
            grads = _split_params(cfg, _np_tree(g), torch.float32, CPU)
            fixed = (torch.tensor(float(jl)), {k: torch.tensor(float(v))
                                               for k, v in jmet.items()},
                     grads)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(step_mod, "loss_and_grads", lambda *a: fixed)
                tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(
                    batch["tokens"])})
            jstate, jmet = jax_step_on(jstate, g, jt)
            want = train_state_from_numpy(cfg, _np_tree(jstate), "cpu")
            out.append(({k: float(v) for k, v in jmet.items()},
                        {k: float(v) for k, v in tmet.items()}, want,
                        tstate))
            continue
        if scheme != "none":
            margin = parted_decision(jm, jstate, tm, tstate, batch, scheme)
            if margin is not None:
                assert margin <= DECISION_MARGIN[scheme], margin
                break
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(
            batch["tokens"])})
        want = train_state_from_numpy(cfg, _np_tree(jstate), "cpu")
        out.append(({k: float(v) for k, v in jmet.items()},
                    {k: float(v) for k, v in tmet.items()}, want, tstate))
    return out


def state_errors(got, want, lr):
    return {
        "step": int(got.opt.step) - int(want.opt.step),
        "params": _max_err(got.params, want.params, lr),
        "master": _max_err(got.opt.master, want.opt.master, lr),
        "m": _max_err(got.opt.m, want.opt.m),
        "v": _max_err(got.opt.v, want.opt.v),
        "error_fb": (_max_err(got.error_fb, want.error_fb)
                     if want.error_fb else 0.0),
    }


@pytest.mark.parametrize("case", CASES, ids=["plain", "microbatches2",
                                             "topk", "int8"])
def test_train_step_matches_jax(case):
    steps = run_both(case)
    assert len(steps) >= (1 if "grad_compression" in case else 3)
    for jmet, tmet, want, got in steps:
        assert set(tmet) == set(jmet) == {"loss", "lm_loss", "aux_loss",
                                          "grad_norm", "lr"}
        for k in ("loss", "lm_loss", "grad_norm"):
            np.testing.assert_allclose(tmet[k], jmet[k], rtol=METRIC_RTOL)
        np.testing.assert_allclose(tmet["lr"], jmet["lr"], rtol=LR_RTOL)
        assert tmet["aux_loss"] == jmet["aux_loss"] == 0.0
        errs = state_errors(got, want, jmet["lr"] or 1.0)
        assert errs["step"] == 0
        for k, tol in STATE_TOL.items():
            if k == "error_fb" and case.get("grad_compression") == "int8":
                tol = INT8_EF_TOL
            assert errs[k] <= tol, (k, errs)
        assert errs["params"] <= STEP_TOL and errs["master"] <= STEP_TOL, errs
