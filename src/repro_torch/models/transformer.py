"""The port's decoder LM.

A port of ``repro/models/transformer.py`` for any ``block_pattern`` over
the temporal-mixing kinds ``attn``, ``local_attn`` (a sliding window of
``attn.window``, 2048 when that is 0) and ``rglru``, each followed by a
dense MLP or, with ``cfg.moe``, a Mixture-of-Experts block: the dense
archs (h2o-danube, smollm, olmo, qwen2.5), the MoE archs (grok-1,
llama4-maverick) and the hybrid recurrentgemma.  The other kinds (xLSTM,
encoder-decoder, vision) are not ported yet and ``build_model`` refuses
them (ROADMAP item 14).

Parameters are a plain dict: ``embed``, ``lm_head`` (untied only),
``final_norm`` and ``layers``, a list with one dict per layer (the JAX
package stacks each pattern position over super-blocks in ``blocks`` for
``lax.scan``; layer i is position i % period of super-block i // period,
and ``repro_torch.convert.model_params_from_numpy`` splits them).  The
forward pass is a Python loop over layers; single device, no training,
so the JAX package's sharding constraints and remat have no counterpart.

Prefill attention: on the card every prompt goes through the
hand-written flash-attention kernel (``impl="kernel"``, the counterpart
of the JAX package's ``"pallas"``, which the JAX prefill reaches only
when asked for).  On the CPU the port keeps the JAX package's rule:
``full`` up to 1024 tokens, which is the kernel wrapper's plain version
on a CPU tensor, and ``chunked`` above, whose memory is O(chunk²).  The
kernel computes the same online-softmax function as ``chunked``; the
port makes the same choice as in its earlier slices, where the kernels
are the default whenever the work lives on the card.

Entry points
------------
  init(generator)                        → params
  prefill(params, batch)                 → (last_logits, cache)
  decode_step(params, cache, tok, pos)   → (logits, cache), in place
  init_cache(batch, capacity, device)    → decode cache: per layer a KV
                                           cache (a ring of the window for
                                           windowed attention) or an
                                           RG-LRU state
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import not_ported
from repro_torch.models.layers import normal
from repro_torch.models.layers.attention import (
    KVCache,
    attention_block,
    attention_output,
    cache_update,
    decode_attention,
    init_attention,
    init_kv_cache,
    qkv_project,
)
from repro_torch.models.layers.mlp import init_mlp, mlp_apply
from repro_torch.models.layers.moe import init_moe, moe_apply
from repro_torch.models.layers.norms import apply_norm, init_norm
from repro_torch.models.layers.rglru import (
    init_rglru,
    init_rglru_state,
    rglru_apply,
    rglru_decode_step,
)
from repro_torch.models.layers.rotary import apply_rope

# The temporal-mixing kinds of ``block_pattern`` the port runs.
MIXERS = ("attn", "local_attn", "rglru")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def params_to(params, device):
    """The parameter tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def _init_block(gen, kind: str, cfg, pdt):
    dev = gen.device
    p: dict = {"norm1": init_norm(cfg.norm, cfg.d_model, pdt, dev)}
    if kind in ("attn", "local_attn"):
        p["attn"] = init_attention(gen, cfg, pdt)
    elif kind == "rglru":
        p["rglru"] = init_rglru(gen, cfg, pdt)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, pdt, dev)
        if cfg.moe is not None:
            p["moe"] = init_moe(gen, cfg, pdt)
        else:
            p["mlp"] = init_mlp(gen, cfg, pdt)
    return p


def _window(kind: str, a) -> int:
    """The attention window of a block kind: ``attn`` the config's (0 =
    full), ``local_attn`` the config's or 2048."""
    return a.window if kind == "attn" else (a.window or 2048)


def _fill_cache(cache: KVCache, k, v) -> KVCache:
    """Prefill's cache write: a linear cache takes the whole prompt; a
    ring cache (capacity < S) the last ``capacity`` positions, each at
    slot pos % capacity."""
    cap, s, b = cache.k.shape[1], k.shape[1], k.shape[0]
    dev = k.device
    if cap >= s:
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
        cache.positions[:, :s] = torch.arange(s, dtype=torch.int32,
                                              device=dev)
        return cache
    tpos = torch.arange(s - cap, s, dtype=torch.int32, device=dev)
    order = torch.argsort(tpos % cap)
    return KVCache(
        k[:, -cap:].to(cache.k.dtype)[:, order],
        v[:, -cap:].to(cache.v.dtype)[:, order],
        tpos[order][None].expand(b, cap).contiguous(),
    )


def _apply_mixer(kind, p, x, cfg, *, impl, positions, cache, pos, decode):
    """Temporal mixing for one block.  Returns (y, new cache entry)."""
    a = cfg.attn
    if kind == "rglru":
        if decode:
            return rglru_decode_step(p["rglru"], x, cfg, cache)
        y, st = rglru_apply(p["rglru"], x, cfg)
        return y, (st if cache is not None else cache)
    window = _window(kind, a)
    if not decode:
        y, k, v = attention_block(p["attn"], x, cfg, impl=impl,
                                  positions=positions,
                                  window_override=window)
        if cache is not None:
            cache = _fill_cache(cache, k, v)
        return y, cache
    q, k, v = qkv_project(p["attn"], x, cfg)
    q = apply_rope(q, pos[:, None], a.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, pos[:, None], a.rope_theta, cfg.rope_scaling)
    cache = cache_update(cache, k.to(cache.k.dtype), v.to(cache.v.dtype),
                         pos)
    o = decode_attention(q, cache.k, cache.v, cache.positions, pos,
                         window=window, softcap=a.softcap)
    return attention_output(p["attn"], o), cache


def _apply_block(kind, p, x, cfg, *, impl, positions, cache, pos, decode):
    """One block: mixer and MLP or MoE, each on a residual.  Returns (x,
    new cache entry, the MoE's aux loss or 0)."""
    y, new_cache = _apply_mixer(
        kind, p, apply_norm(cfg.norm, p.get("norm1"), x), cfg, impl=impl,
        positions=positions, cache=cache, pos=pos, decode=decode)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff > 0:
        h = apply_norm(cfg.norm, p.get("norm2"), x)
        if cfg.moe is not None:
            mo, aux = moe_apply(p["moe"], h, cfg)
            x = x + mo
        else:
            x = x + mlp_apply(p["mlp"], h, cfg)
    return x, new_cache, aux


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    kinds = {"xLSTM": cfg.xlstm, "encoder-decoder": cfg.encoder,
             "vision": cfg.vision}
    for kind, part in kinds.items():
        if part is not None:
            raise not_ported(f"{cfg.name}: the {kind} block")
    for kind in cfg.block_pattern:
        if kind not in MIXERS:
            raise not_ported(f"{cfg.name}: the {kind!r} block kind")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass
class Model:
    cfg: ModelConfig

    # ---- init ------------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random weights with the JAX init's shapes and scales, drawn from
        ``generator`` on its device (CPU and CUDA generators give different
        numbers for one seed)."""
        cfg = self.cfg
        pdt = dtype_of(cfg.param_dtype)
        dev = generator.device
        vp, d = cfg.padded_vocab, cfg.d_model
        params: dict = {"embed": normal(generator, (vp, d), d ** -0.5, pdt)}
        if not cfg.tie_embeddings:
            params["lm_head"] = normal(generator, (d, vp), d ** -0.5, pdt)
        params["final_norm"] = init_norm(cfg.norm, d, pdt, dev)
        params["layers"] = [_init_block(generator, self.kind(i), cfg, pdt)
                            for i in range(cfg.n_layers)]
        return params

    def kind(self, i: int) -> str:
        """Layer i's temporal-mixing kind."""
        pattern = self.cfg.block_pattern
        return pattern[i % len(pattern)]

    # ---- embedding / unembedding ------------------------------------------
    def _embed_tokens(self, params, tokens):
        embed = params["embed"]
        if tokens.device != embed.device:
            raise ValueError(f"tokens on {tokens.device}, parameters on "
                             f"{embed.device}")
        return embed[tokens.long()].to(dtype_of(self.cfg.dtype))

    def _logits(self, params, x):
        cfg = self.cfg
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ head.to(x.dtype)

    # ---- forward (prefill) ------------------------------------------------
    def _backbone(self, params, x, *, impl, cache=None):
        """x: (B, S, D).  Runs every layer; returns (x, caches, aux)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, p in enumerate(params["layers"]):
            x, nc, a = _apply_block(
                self.kind(i), p, x, cfg, impl=impl, positions=positions,
                cache=cache[i] if cache is not None else None, pos=None,
                decode=False)
            caches.append(nc)
            aux = aux + a
        x = apply_norm(cfg.norm, params.get("final_norm"), x)
        return x, (caches if cache is not None else []), aux

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, device=None):
        """Decode cache: per layer a KV cache (a ring of ``window`` slots
        for windowed attention, else ``capacity`` slots) or, for an
        ``rglru`` layer, a zero RG-LRU state."""
        a = self.cfg.attn
        adt = dtype_of(self.cfg.dtype)

        def one(kind):
            if kind == "rglru":
                return init_rglru_state(batch, self.cfg, adt, device)
            window = _window(kind, a)
            cap = min(capacity, window) if window else capacity
            return init_kv_cache(batch, cap, a.n_kv_heads, a.head_dim, adt,
                                 device)

        layers = [one(self.kind(i)) for i in range(self.cfg.n_layers)]
        return {"layers": layers,
                "step_offset": torch.zeros((batch,), dtype=torch.int32,
                                           device=device)}

    def prefill(self, params, batch, *, max_new_tokens: int = 64):
        """Run the prompt, build the decode cache (with ``max_new_tokens``
        of headroom for linear caches), return the last logits.

        The attention path follows the tensors: the flash-attention
        kernel on the card at every length; on the CPU the kernel's
        plain version (the JAX package's ``full``) up to 1024 tokens and
        ``chunked`` above, as the JAX package."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed_tokens(params, tokens)
        cache0 = self.init_cache(b, s + max_new_tokens, device=x.device)
        impl = "chunked" if not x.is_cuda and s > 1024 else "kernel"
        x, caches, _ = self._backbone(params, x, impl=impl,
                                      cache=cache0["layers"])
        logits = self._logits(params, x[:, -1:])
        cache = {"layers": caches,
                 "step_offset": torch.full((b,), s, dtype=torch.int32,
                                           device=x.device)}
        return logits[:, 0], cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1) int; pos: (B,) absolute positions.  Returns
        (logits (B, V), cache); the cache is updated in place (a KV
        cache's tensors, an RG-LRU layer's entry of ``cache["layers"]``)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        layers = cache["layers"]
        for i, p in enumerate(params["layers"]):
            x, layers[i], _ = _apply_block(self.kind(i), p, x, cfg,
                                           impl=None, positions=None,
                                           cache=layers[i], pos=pos,
                                           decode=True)
        x = apply_norm(cfg.norm, params.get("final_norm"), x)
        return self._logits(params, x)[:, 0], cache
