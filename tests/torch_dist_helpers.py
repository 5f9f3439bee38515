"""Shared pieces of the sharded-runtime parity files (``tests/test_torch_
distributed*.py``): the problems, the reference run and the key.

The reference needs forced host devices, and ``tests/conftest.py``
imports jax before any test could set them, so each file runs its
reference in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_
device_count=8`` (as ``tests/test_distributed.py::_run`` does), started
before the port's ranks so the two run side by side.  The port runs in
one ``spawn_ranks`` launch (gloo, CPU) per file.  Spawned ranks import
the test module by name, so this module and the test modules keep JAX
out of their top level: ``JaxKey`` imports it in its methods.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

TESTS = os.path.abspath(os.path.dirname(__file__))
SRC = os.path.abspath(os.path.join(TESTS, "..", "src"))
REPO = os.path.abspath(os.path.join(TESTS, ".."))

# Each file's launch and reference run are cut at these limits, well
# above the ~10-25 s they take, so a hang fails instead of stalling.
LAUNCH_TIMEOUT_S = 240.0
REFERENCE_TIMEOUT_S = 300.0

# Values against the reference: f32 sums in another order.
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax

    from repro.core import estimators as jest

    return (jax.jit(jax.random.split, static_argnums=1),
            jax.jit(jax.random.fold_in),
            jax.jit(jest.gumbel_noise, static_argnums=1))


class JaxKey:
    """The port's key interface over a raw JAX PRNG key (numpy uint32):
    ``split``, ``fold_in``, the Gumbel and normal draws are the
    reference's; ``as_array``/``from_array`` carry it in a checkpoint."""

    def __init__(self, key):
        self.key = np.asarray(key, dtype=np.uint32)

    @classmethod
    def seed(cls, s: int) -> "JaxKey":
        # jax.random.PRNGKey(s) for the default threefry key, s < 2**32.
        return cls(np.array([0, s], dtype=np.uint32))

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_jax_fns()[0](self.key, num))]

    def fold_in(self, i):
        return JaxKey(np.asarray(_jax_fns()[1](self.key, i)))

    def gumbel(self, n, device):
        import torch

        g = np.array(_jax_fns()[2](self.key, n))
        return torch.from_numpy(g).to(device)

    def normal(self, shape, device):
        import jax
        import torch

        z = np.array(jax.random.normal(self.key, tuple(shape)))
        return torch.from_numpy(z).to(device)

    def as_array(self):
        return self.key.copy()

    @classmethod
    def from_array(cls, a):
        return cls(np.asarray(a, np.uint32))


# ---------------------------------------------------------------------------
# the problems (numpy f32, the same bits for both packages)
# ---------------------------------------------------------------------------

def _normalize(X0):
    X = X0 - X0.mean(axis=0, keepdims=True)
    return X / np.maximum(np.sqrt((X * X).sum(axis=0, keepdims=True)), 1e-12)


def reg_problem():
    """The reference's runtime suite regression problem: 96 × 64, k 8."""
    rng = np.random.default_rng(0)
    d, n, k = 96, 64, 8
    X0 = rng.normal(size=(d, n)) + 0.4 * rng.normal(size=(d, 1))
    w = np.zeros(n)
    w[:k] = rng.uniform(-2, 2, k)
    y = X0 @ w + 0.1 * rng.normal(size=d)
    return (_normalize(X0).astype(np.float32), y.astype(np.float32), k)


def aopt_problem():
    """24 × 48 unit columns, k 8."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(24, 48))
    return (X / np.linalg.norm(X, axis=0, keepdims=True)).astype(
        np.float32), None, 8


def aopt_scaled_problem():
    """The 24 × 48 design with its columns scaled by seeded factors in
    [0.5, 1.5]: every singleton gain of the unit-norm design is 0.5 in
    exact arithmetic, so greedy and TOP-k break f32 ties there (as in
    ``tests/test_torch_aopt.py``'s scaled design)."""
    X, _, k = aopt_problem()
    scale = np.random.default_rng(9).uniform(0.5, 1.5, size=(1, X.shape[1]))
    return (X * scale).astype(np.float32), None, k


def logi_problem():
    """120 × 32 logistic problem (seed 7, the reference's healthy one), k 6,
    4 IRLS steps and 2 Newton gain steps."""
    rng = np.random.default_rng(7)
    d, n, k = 120, 32, 6
    X0 = rng.normal(size=(d, n))
    X = _normalize(X0) * np.sqrt(d)
    w = np.zeros(n)
    w[:k] = rng.uniform(-2, 2, k)
    y = (1 / (1 + np.exp(-X0 @ w)) > 0.5)
    return X.astype(np.float32), y.astype(np.float32), k


def _tie_columns(X, seed):
    """X's first 6 columns, 8 copies each, in a seeded order: every gain
    ties 8 ways in exact arithmetic, at 48 positions of the ground set."""
    part = X[:, :6]
    order = np.random.default_rng(seed).permutation(8 * part.shape[1])
    return np.ascontiguousarray(np.concatenate([part] * 8, axis=1)[:, order])


def reg_tied_problem():
    """The regression problem's first 6 columns, 8 copies each: 96 × 48,
    k 8."""
    X, y, k = reg_problem()
    return _tie_columns(X, 11), y, k


def logi_tied_problem():
    """The logistic problem's first 6 columns, 8 copies each: 120 × 48,
    k 6."""
    X, y, k = logi_problem()
    return _tie_columns(X, 12), y, k


def aopt_tied_problem():
    """The scaled design's first 6 columns (no f32 tie between them), 8
    copies each: 24 × 48, k 8."""
    X, _, k = aopt_scaled_problem()
    return _tie_columns(X, 13), None, k


PROBLEMS = {"reg": reg_problem, "aopt": aopt_problem,
            "aopt_scaled": aopt_scaled_problem, "logi": logi_problem,
            "reg_tied": reg_tied_problem, "logi_tied": logi_tied_problem,
            "aopt_tied": aopt_tied_problem}
LOGI_KW = {"newton_steps": 4, "newton_gain_steps": 2}
# The reference suite's DASH settings per objective.
DASH_CFG = {"reg": dict(eps=0.25, alpha=0.6, n_samples=4),
            "aopt": dict(eps=0.25, alpha=0.5, n_samples=4),
            "logi": dict(eps=0.3, alpha=0.4, n_samples=3)}


def port_objective(name, device="cpu", **kw):
    from repro_torch.core import (
        AOptimalityObjective,
        ClassificationObjective,
        RegressionObjective,
    )

    X, y, k = PROBLEMS[name]()
    if name.startswith("reg"):
        return RegressionObjective(X, y, k, device=device, **kw), k
    if name.startswith("aopt"):
        return AOptimalityObjective(X, k, device=device, **kw), k
    return ClassificationObjective(X, y, k, device=device, **LOGI_KW,
                                   **kw), k


# Reference-side objective construction (run in the subprocess).
REF_PRELUDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
import torch_dist_helpers as H
from repro.core import (AOptimalityObjective, ClassificationObjective,
                        DashConfig, RegressionObjective)
from repro.launch.mesh import make_mesh

def ref_objective(name, **kw):
    X, y, k = H.PROBLEMS[name]()
    if name.startswith("reg"):
        return RegressionObjective(jnp.asarray(X), jnp.asarray(y), kmax=k,
                                   **kw), k
    if name.startswith("aopt"):
        return AOptimalityObjective(jnp.asarray(X), kmax=k, **kw), k
    return ClassificationObjective(jnp.asarray(X), jnp.asarray(y), kmax=k,
                                   **H.LOGI_KW, **kw), k

def mask_idx(m):
    return [int(i) for i in np.flatnonzero(np.asarray(m))]

def floats(x):
    return [float(v) for v in np.asarray(x).reshape(-1)]
"""


def start_reference(body: str, devices: int = 8) -> subprocess.Popen:
    """Start the reference's run of ``body`` (after REF_PRELUDE) in a
    subprocess with forced host devices; its last stdout line is JSON."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    code = REF_PRELUDE.format(tests=TESTS) + textwrap.dedent(body)
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def finish_reference(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def launch(fn, world: int, *args):
    """The port on ``world`` gloo ranks on the CPU; per-rank results."""
    from repro_torch.launch.mesh import spawn_ranks

    return spawn_ranks(fn, world, args, device="cpu",
                       timeout_s=LAUNCH_TIMEOUT_S)


def idx(mask) -> list:
    return [int(i) for i in np.flatnonzero(np.asarray(mask))]


def same_on_every_rank(results) -> None:
    """Every rank returned the same tree, bit for bit."""
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        assert _bits(other) == _bits(first), f"rank {r} differs from rank 0"


def _bits(tree):
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_bits(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return (tree.dtype.str, tree.shape, tree.tobytes())
    return tree
