"""Hand-written CUDA kernels (sm_90a) for the port's hot spots.

Each kernel package has two modules:
  ops.py — the wrapper: checks, allocation, launch on the current stream
           through ``_build`` (nvcc + ctypes) for a CUDA tensor; the plain
           version for a CPU tensor
  ref.py — the plain PyTorch version, a transliteration of the JAX
           reference; the CPU path and the kernel's parity oracle

Kernels:
  marginal_gains — fused batched regression singleton-gain sweep
                   (greedy's oracle, DASH's current-state fallback)
  aopt_gains     — the A-optimality Sherman–Morrison singleton sweep
                   against the cached shared solve W = M⁻¹X
  logistic_gains — the 1-D-Newton logistic singleton sweep: steps
                   Newton iterations per column, X held on chip across
                   a cluster of CTAs, one device kernel per call
  filter_gains   — sample-batched filter engine with the regression, the
                   A-optimality (Woodbury) and the logistic (Newton
                   sweep) epilogues (DASH's inner-loop hot spot)
  flash_attention — online-softmax attention with GQA, causal, window,
                   softcap and q_offset masks (every LM prefill layer on
                   the card; tensor cores for bf16, CUDA cores for f32)

The CUDA sources live in ``csrc/``; ``common`` holds the precision policy
and the device rule.
"""
