"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference package ``repro``.  It never
imports JAX or ``repro``; its tests hold it against the reference on the
same numpy inputs.  Slice 1 carries the paper's main path, DASH feature
selection for sparse regression on one device
(``repro_torch.quickstart``); slice 2 Bayesian A-optimal experimental
design (``repro_torch.experimental_design``); slice 3 feature selection
for logistic classification (``repro_torch.classification``); slice 4
LM serving, prefill and decode of the dense attention-only archs
(``repro_torch.serve_lm``), joined in slice 9 by the MoE archs (grok-1,
llama4-maverick) and the RG-LRU hybrid (recurrentgemma); slice 5 the ``select`` registry and the
paper's §5 roster — lazy and stochastic greedy, FAST, adaptive
sequencing, LASSO — with the §5 comparison
(``repro_torch.bench_selection``); slice 6 the other objectives (R²,
cluster diversity with the diversified design, training-batch coresets
from an LM's features) and the single-device resilience layer
(checkpoints, restarts, hedged resumes, ``dash_checkpointed``); slice 7
the sharded runtime on ``torch.distributed`` (``launch/mesh.py``,
``core/distributed.py``: sharded DASH and its guess lattice, the sharded
baselines and FAST behind ``select(..., mesh=)``, round snapshots and
elastic resumes); slice 8 the selection service (``serve/``); slice 10
the xLSTM, encoder-decoder and VLM archs; slice 11 single-device
training with selection in the loop (``Model.loss``, ``optim``,
``train``, the token pipeline and ``BatchSelector``;
``repro_torch.train_lm_with_selection``, ``repro_torch.launch.train``);
slice 12 data-parallel training on a mesh (``sharding``,
``train_loop(mesh=)``, ``launch.train --mesh``) and the
continuous-batching ``train.engine.ServeEngine``.

Layers:
  repro_torch.kernels  — hand-written CUDA C++ kernels for sm_90a (the
                         regression, A-optimality and logistic
                         singleton-gain sweeps and sample-batched filter
                         engines; flash attention), their plain PyTorch
                         versions and the nvcc/ctypes build
  repro_torch.core     — the regression, A-optimality, classification,
                         R², diversity and coreset objectives,
                         estimators, the lane-batched DASH selection loop
                         and its round-checkpointed driver, the
                         ``select`` registry and its
                         §5 roster (greedy family, FAST, adaptive
                         sequencing, the one-shot baselines), LASSO and
                         the γ/α estimators
  repro_torch.launch   — process meshes on torch.distributed and the
                         launcher of local ranks
  repro_torch.ckpt     — atomic, manifest-checked checkpoints (npz)
  repro_torch.runtime  — restarts, hedged resumes, the straggler
                         simulator, elastic meshes and resharding
  repro_torch.data     — the paper's synthetic D1–D4 and D1 design data
                         and the LM token stream (numpy only), the
                         token pipeline and training-batch selection
  repro_torch.optim    — AdamW with an f32 master, the cosine schedule,
                         gradient compression with error feedback
  repro_torch.train    — the train step (one device or data parallel on
                         a mesh), the training loop with
                         checkpoint/restart and selection in the loop,
                         and the continuous-batching serving engine
  repro_torch.sharding — the perf flags, mesh placements of parameters,
                         caches and batches, and the batch-axes context
                         of data-parallel training
  repro_torch.tree     — nested dict/list/tuple trees of tensors
  repro_torch.configs  — the LM configs (copies of the JAX package's:
                         dense, MoE, hybrid) and their registry
  repro_torch.models   — the decoder LM: norms, RoPE, MLP, MoE,
                         attention with KV and ring caches, RG-LRU with
                         its state, prefill and decode
  repro_torch.lm_serve — prefill/decode steps, sampling, ``generate``
  repro_torch.convert  — numpy state in, port state out (parity tests)

Entry points run on the card (``device=None`` means ``"cuda"``) and raise
when there is none, unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
