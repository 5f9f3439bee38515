"""The port's LM: decoder, encoder-decoder and image-prefix models.

A port of ``repro/models/transformer.py`` for any ``block_pattern`` over
the temporal-mixing kinds ``attn``, ``local_attn`` (a sliding window of
``attn.window``, 2048 when that is 0), ``rglru``, ``mlstm`` and
``slstm``, each followed by a dense MLP or, with ``cfg.moe``, a
Mixture-of-Experts block (no MLP when ``d_ff`` is 0, as xLSTM's): the
dense archs (h2o-danube, smollm, olmo, qwen2.5), the MoE archs (grok-1,
llama4-maverick), the hybrid recurrentgemma and xlstm-125m.  With
``cfg.encoder`` (whisper) an encoder stack turns the batch's
``enc_frames`` into ``enc_out``, and every decoder block adds a
cross-attention over it; with ``cfg.vision`` (internvl2) the batch's
``img_embeds`` are projected by ``img_proj`` and prepended to the text
embeddings.  Both frontends are stubs in the JAX package too: the batch
carries precomputed frame or patch embeddings.

Parameters are a plain dict: ``embed``, ``lm_head`` (untied only),
``final_norm``, ``img_proj`` (vision), ``enc_layers`` and
``enc_final_norm`` (encoder) and ``layers``, a list with one dict per
layer (the JAX package stacks each pattern position over super-blocks
in ``blocks`` and the encoder's layers in ``enc_blocks`` for
``lax.scan``; layer i is position i % period of super-block i // period,
and ``repro_torch.convert.model_params_from_numpy`` splits both).  The
forward pass is a Python loop over layers.  Data-parallel training
(``sharding.activation_sharding_ctx``) stands in for the JAX package's
sharding constraints with explicit collectives where the batch's rows
meet: ``loss``'s token count and the MoE's dispatch and aux loss.
With ``cfg.remat`` the training loss checkpoints each layer
(``torch.utils.checkpoint``), the counterpart of the reference's
per-sub-layer ``jax.checkpoint``.  Under tensor parallelism
(``sharding/tensor_parallel.py``) the parameters are a rank's shards:
attention, the MLP and the MoE run their split products with sums or
gathers over ``model``, the embedding is a masked lookup summed over
it, the loss a vocab-parallel cross-entropy, the served logits gathered,
and the decode cache is the rank's block of KV heads or of slots.

Attention: on the card every prefill self-attention, the encoder's
bidirectional attention and every cross-attention (prefill and decode)
go through the hand-written flash-attention kernel (``impl="kernel"``,
the counterpart of the JAX package's ``"pallas"``, which the JAX prefill
reaches only when asked for).  On the CPU the port keeps the JAX
package's rule: ``full`` up to 1024 positions (the image prefix counts),
which is the kernel wrapper's plain version on a CPU tensor, and
``chunked`` above, whose memory is O(chunk²); the encoder and the
cross-attention are ``full`` there, as the reference's.  The kernel
computes the same online-softmax function as ``chunked``; the port
makes the same choice as in its earlier slices, where the kernels are
the default whenever the work lives on the card.

Training: ``loss`` runs attention through the plain ``full`` path up to
1024 positions (the image prefix counts) and ``chunked`` above, on the
CPU and on the card alike, and the encoder and the cross-attention
through ``full`` — the reference's loss never reaches its Pallas kernel,
whose forward-only kernel has no gradient, and neither does the port's.

Entry points
------------
  init(generator)                        → params
  param_specs()                          → params as ``meta`` tensors
  loss(params, batch)                    → (loss + aux, {lm_loss,
                                           aux_loss}), differentiable
  prefill(params, batch)                 → (last_logits, cache)
  decode_step(params, cache, tok, pos)   → (logits, cache), in place
  init_cache(batch, capacity, device)    → decode cache: per layer a KV
                                           cache (a ring of the window for
                                           windowed attention), an RG-LRU
                                           or an xLSTM state; ``enc_out``
                                           for an encoder-decoder
  input_specs(shape)                     → the inputs of a ShapeConfig
                                           cell as ``meta`` tensors
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import MetaGenerator, normal
from repro_torch.models.layers.attention import (
    KVCache,
    SlotKVCache,
    attention_block,
    attention_output,
    cache_update,
    cache_update_slots,
    decode_attention,
    decode_attention_slots,
    full_attention,
    init_attention,
    init_kv_cache,
    qkv_project,
    slot_positions,
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
from repro_torch.models.layers.xlstm import (
    init_xlstm_block,
    init_xlstm_state,
    xlstm_block_apply,
)
from repro_torch.sharding.partitioning import batch_group, captured_context
from repro_torch.sharding.tensor_parallel import kv_layout, model_group
from repro_torch.tree import tree_map

# The temporal-mixing kinds of ``block_pattern`` the port runs.
MIXERS = ("attn", "local_attn", "rglru", "mlstm", "slstm")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def params_to(params, device):
    """The parameter tree (or any tree, a ``TrainState``) with every
    tensor moved to ``device``."""
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def _init_block(gen, kind: str, cfg, pdt, *, cross_attn: bool):
    dev = gen.device
    p: dict = {"norm1": init_norm(cfg.norm, cfg.d_model, pdt, dev)}
    if kind in ("attn", "local_attn"):
        p["attn"] = init_attention(gen, cfg, pdt)
    elif kind == "rglru":
        p["rglru"] = init_rglru(gen, cfg, pdt)
    elif kind in ("mlstm", "slstm"):
        p["xlstm"] = init_xlstm_block(gen, kind, cfg, pdt)
    else:
        raise ValueError(kind)
    if cross_attn:
        p["norm_x"] = init_norm(cfg.norm, cfg.d_model, pdt, dev)
        p["xattn"] = init_attention(gen, cfg, pdt)
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


def _fill_cache(cache: KVCache, k, v, grp=None) -> KVCache:
    """Prefill's cache write: a linear cache takes the whole prompt; a
    ring cache (capacity < S) the last ``capacity`` positions, each at
    slot pos % capacity.  A ``SlotKVCache`` (``grp``: its model group)
    takes only this rank's block of the slots."""
    if isinstance(cache, SlotKVCache):
        return _fill_slots(cache, k, v, grp)
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


def _fill_slots(cache: SlotKVCache, k, v, grp) -> SlotKVCache:
    """``_fill_cache`` on this rank's block [lo, lo + C) of the M·C
    slots: the whole cache's layout, cut."""
    cl, s, b = cache.k.shape[1], k.shape[1], k.shape[0]
    cap, lo = cl * grp.size, grp.index * cl
    dev = k.device
    whole_pos = cache.positions.shape[1] != cl
    if cap >= s:
        n = max(0, min(cl, s - lo))
        cache.k[:, :n] = k[:, lo:lo + n].to(cache.k.dtype)
        cache.v[:, :n] = v[:, lo:lo + n].to(cache.v.dtype)
        if whole_pos:
            cache.positions[:, :s] = torch.arange(s, dtype=torch.int32,
                                                  device=dev)
        else:
            cache.positions[:, :n] = torch.arange(lo, lo + n,
                                                  dtype=torch.int32,
                                                  device=dev)
        return cache
    tpos = torch.arange(s - cap, s, dtype=torch.int32, device=dev)
    order = torch.argsort(tpos % cap)
    mine = order[lo:lo + cl]
    positions = tpos[order if whole_pos else mine][None].expand(b, -1)
    return SlotKVCache(k[:, -cap:].to(cache.k.dtype)[:, mine],
                       v[:, -cap:].to(cache.v.dtype)[:, mine],
                       positions.contiguous())


def _apply_mixer(kind, p, x, cfg, *, impl, positions, cache, pos, decode):
    """Temporal mixing for one block.  Returns (y, new cache entry)."""
    a = cfg.attn
    if kind == "rglru":
        if decode:
            return rglru_decode_step(p["rglru"], x, cfg, cache)
        y, st = rglru_apply(p["rglru"], x, cfg)
        return y, (st if cache is not None else cache)
    if kind in ("mlstm", "slstm"):
        state = cache if cache is not None else init_xlstm_state(
            kind, x.shape[0], cfg, x.dtype, x.device)
        y, st = xlstm_block_apply(kind, p["xlstm"], x, cfg, state,
                                  decode=decode)
        return y, (st if cache is not None else cache)
    window = _window(kind, a)
    if not decode:
        y, k, v = attention_block(p["attn"], x, cfg, impl=impl,
                                  positions=positions,
                                  window_override=window)
        if cache is not None:
            cache = _fill_cache(cache, k, v, model_group(cfg))
        return y, cache
    q, k, v = qkv_project(p["attn"], x, cfg)
    q = apply_rope(q, pos[:, None], a.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, pos[:, None], a.rope_theta, cfg.rope_scaling)
    k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if isinstance(cache, SlotKVCache):
        grp = model_group(cfg)
        cache = cache_update_slots(cache, k, v, pos, grp)
        o = decode_attention_slots(q, cache.k, cache.v,
                                   slot_positions(cache, grp), pos, grp,
                                   window=window, softcap=a.softcap)
    else:
        cache = cache_update(cache, k, v, pos)
        o = decode_attention(q, cache.k, cache.v, cache.positions, pos,
                             window=window, softcap=a.softcap)
    return attention_output(p["attn"], o, cfg), cache


def _attend(impl):
    """The encoder's and the cross-attention's attention for a
    self-attention ``impl``: the plain ``full`` for the loss's paths
    (``full``, ``chunked``), else the kernel wrapper (kernel 8 on the
    card, the same plain version on the CPU), looked up at call time."""
    return full_attention if impl in ("full", "chunked") else flash_attention


def _apply_cross_attn(p, x, enc_out, cfg, impl="kernel"):
    """Decoder cross-attention (whisper): no RoPE, non-causal, K and V
    projected from ``enc_out`` at every call (decode steps too, as the
    reference); kernel 8's wrapper, or ``full_attention`` for the loss
    (``_attend(impl)``)."""
    b, s, _ = x.shape
    a = cfg.attn
    se = enc_out.shape[1]
    q = (x @ p["xattn"]["wq"]).reshape(b, s, a.n_heads, a.head_dim)
    k = (enc_out @ p["xattn"]["wk"]).reshape(b, se, a.n_kv_heads, a.head_dim)
    v = (enc_out @ p["xattn"]["wv"]).reshape(b, se, a.n_kv_heads, a.head_dim)
    o = _attend(impl)(q, k, v, causal=False, window=0, softcap=0.0)
    return attention_output(p["xattn"], o, cfg)


def _apply_block(kind, p, x, cfg, *, impl, positions, cache, pos, decode,
                 enc_out=None):
    """One block: mixer, cross-attention (given ``enc_out`` and a block
    that has one) and MLP or MoE, each on a residual.  Returns (x, new
    cache entry, the MoE's aux loss or 0)."""
    y, new_cache = _apply_mixer(
        kind, p, apply_norm(cfg.norm, p.get("norm1"), x), cfg, impl=impl,
        positions=positions, cache=cache, pos=pos, decode=decode)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if enc_out is not None and "xattn" in p:
        x = x + _apply_cross_attn(
            p, apply_norm(cfg.norm, p.get("norm_x"), x), enc_out, cfg, impl)
    if cfg.d_ff > 0:
        h = apply_norm(cfg.norm, p.get("norm2"), x)
        if cfg.moe is not None:
            mo, aux = moe_apply(p["moe"], h, cfg)
            x = x + mo
        else:
            x = x + mlp_apply(p["mlp"], h, cfg)
    return x, new_cache, aux


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind that no arch uses."""
    for kind in cfg.block_pattern:
        if kind not in MIXERS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}; "
                             f"expected one of {MIXERS}")


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
        if cfg.vision is not None:
            e = cfg.vision.embed_dim
            params["img_proj"] = normal(generator, (e, d), e ** -0.5, pdt)
        params["layers"] = [
            _init_block(generator, self.kind(i), cfg, pdt,
                        cross_attn=cfg.is_encdec)
            for i in range(cfg.n_layers)]
        if cfg.is_encdec:
            params["enc_layers"] = [{
                "norm1": init_norm(cfg.norm, d, pdt, dev),
                "enc_attn": init_attention(generator, cfg, pdt),
                "norm2": init_norm(cfg.norm, d, pdt, dev),
                "mlp": init_mlp(generator, cfg, pdt),
            } for _ in range(cfg.encoder.n_layers)]
            params["enc_final_norm"] = init_norm(cfg.norm, d, pdt, dev)
        return params

    def param_specs(self):
        """The parameter tree as ``meta`` tensors: shapes and dtypes of
        ``init`` at any width, with no storage."""
        return self.init(MetaGenerator())

    def kind(self, i: int) -> str:
        """Layer i's temporal-mixing kind."""
        pattern = self.cfg.block_pattern
        return pattern[i % len(pattern)]

    # ---- encoder (whisper) ------------------------------------------------
    def _encode(self, params, frames, impl="kernel"):
        """frames: (B, src_len, D) → enc_out (B, src_len, D): per layer
        RoPE'd bidirectional self-attention (``_attend(impl)``: kernel 8
        at ``causal=False`` on the card, ``full_attention`` for the loss)
        and an MLP, each on a residual, then ``enc_final_norm``."""
        cfg = self.cfg
        a = cfg.attn
        x = frames.to(dtype_of(cfg.dtype))
        positions = torch.arange(x.shape[1], device=x.device)
        for p in params["enc_layers"]:
            h = apply_norm(cfg.norm, p.get("norm1"), x)
            q, k, v = qkv_project(p["enc_attn"], h, cfg)
            q = apply_rope(q, positions, a.rope_theta, cfg.rope_scaling)
            k = apply_rope(k, positions, a.rope_theta, cfg.rope_scaling)
            o = _attend(impl)(q, k, v, causal=False, window=0,
                              softcap=0.0)
            x = x + attention_output(p["enc_attn"], o, cfg)
            h = apply_norm(cfg.norm, p.get("norm2"), x)
            x = x + mlp_apply(p["mlp"], h, cfg)
        return apply_norm(cfg.norm, params.get("enc_final_norm"), x)

    # ---- embedding / unembedding ------------------------------------------
    def _vocab_group(self):
        """The model group where the context splits the vocabulary over
        ``model``, else None."""
        grp = model_group(self.cfg)
        return grp if grp is not None and grp.layout.vocab else None

    def _embed_tokens(self, params, tokens):
        """The tokens' embeddings; with the vocabulary split over
        ``model``, each rank looks up the tokens in its block of rows
        (the others zero) and the rows are summed over the axis."""
        embed = params["embed"]
        if tokens.device != embed.device:
            raise ValueError(f"tokens on {tokens.device}, parameters on "
                             f"{embed.device}")
        adt = dtype_of(self.cfg.dtype)
        grp = self._vocab_group()
        if grp is None:
            return embed[tokens.long()].to(adt)
        n = embed.shape[0]
        t = tokens.long() - grp.index * n
        inside = (t >= 0) & (t < n)
        rows = embed[torch.clamp(t, 0, n - 1)] * inside[..., None].to(
            embed.dtype)
        return grp.reduce(rows.float(), adt)

    def _logits(self, params, x, whole: bool = True):
        """x (B, S, D) → logits (B, S, V).  With the vocabulary split over
        ``model`` each rank computes its block of columns; ``whole``
        gathers them (serving, no gradient), else the block is returned
        (the loss's vocab-parallel cross-entropy)."""
        cfg = self.cfg
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        grp = self._vocab_group()
        if grp is None:
            return x @ head.to(x.dtype)
        local = grp.enter(x) @ head.to(x.dtype)
        return grp.cat_last(local) if whole else local

    def _nll(self, params, x, labels):
        """The next-token NLL (B, S) in f32 over the padded vocab:
        logsumexp − the gold logit; with the vocabulary split over
        ``model``, vocab-parallel (the row maxima, the sums of
        exponentials and the gold logits reduced over the axis), the
        logits never gathered."""
        grp = self._vocab_group()
        lf = self._logits(params, x, whole=False).to(torch.float32)
        if grp is None:
            lse = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, labels[..., None])[..., 0]
            return lse - gold
        n = lf.shape[-1]
        mx = grp.pmax(torch.amax(lf, dim=-1))
        se = grp.reduce(torch.sum(torch.exp(lf - mx[..., None]), dim=-1),
                        torch.float32)
        t = labels - grp.index * n
        inside = (t >= 0) & (t < n)
        gold = torch.gather(lf, -1, torch.clamp(t, 0, n - 1)[..., None])
        gold = grp.reduce(gold[..., 0] * inside, torch.float32)
        return mx + torch.log(se) - gold

    def _inputs(self, params, batch, impl="kernel"):
        """The input embeddings, with the projected image prefix in front
        (vision), and the encoder's output (encoder-decoder, else None;
        its attention is ``_attend(impl)``)."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"])
        if cfg.vision is not None:
            img = batch["img_embeds"].to(device=x.device, dtype=x.dtype)
            x = torch.cat([img @ params["img_proj"].to(x.dtype), x], dim=1)
        enc_out = None
        if cfg.is_encdec:
            enc_out = self._encode(params, batch["enc_frames"].to(x.device),
                                   impl)
        return x, enc_out

    # ---- forward (train / prefill shared) -----------------------------------
    def _backbone(self, params, x, *, impl, cache=None, enc_out=None,
                  remat=False):
        """x: (B, S, D).  Runs every layer; returns (x, caches, aux).
        ``remat`` recomputes each layer's activations in the backward
        (training only: a layer that fills a cache is not checkpointed)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # a checkpointed layer's recompute runs on autograd's thread
        enter = captured_context()
        for i, p in enumerate(params["layers"]):
            def block(x, p=p, kind=self.kind(i),
                      c=cache[i] if cache is not None else None):
                with enter():
                    return _apply_block(kind, p, x, cfg, impl=impl,
                                        positions=positions, cache=c,
                                        pos=None, decode=False,
                                        enc_out=enc_out)

            if remat and cache is None:
                x, nc, a = checkpoint(block, x, use_reentrant=False)
            else:
                x, nc, a = block(x)
            caches.append(nc)
            aux = aux + a
        x = apply_norm(cfg.norm, params.get("final_norm"), x)
        return x, (caches if cache is not None else []), aux

    # ---- training loss ------------------------------------------------------
    def loss(self, params, batch):
        """batch: dict(tokens (B, S) int [, img_embeds | enc_frames]) on
        the parameters' device.  Causal LM loss; an encoder-decoder uses
        teacher forcing on the decoder tokens.  Returns (loss + aux,
        {"lm_loss", "aux_loss"}), f32 scalars.

        Labels are the tokens shifted by one (the last position wraps and
        is masked out); the cross-entropy is logsumexp − the gold logit
        in f32 over the padded vocab, the gold logit taken by a gather
        (the reference contracts with a one-hot, a sharding device).

        Under ``sharding.activation_sharding_ctx`` with a mesh, ``batch``
        is this rank's rows and the loss and both metrics are this
        rank's shares of the global batch's: summed over the batch axes
        they give the reference's values, and so do the gradients."""
        cfg = self.cfg
        tokens = batch["tokens"]
        n_prefix = cfg.vision.n_img_tokens if cfg.vision is not None else 0
        n = tokens.shape[1] + n_prefix
        impl = "full" if n <= 1024 else "chunked"
        x, enc_out = self._inputs(params, batch, impl)
        x, _, aux = self._backbone(params, x, impl=impl, enc_out=enc_out,
                                   remat=cfg.remat)
        labels = torch.roll(tokens.long(), -1, dims=1)
        lmask = torch.ones(labels.shape, dtype=torch.float32,
                           device=labels.device)
        lmask[:, -1] = 0.0
        nll = self._nll(params, x[:, n_prefix:], labels)
        count = torch.sum(lmask)
        grp = batch_group()
        if grp is not None:
            # Data parallel: this rank's share of the global loss, whose
            # gradient is its rows' share of the global gradient.  The
            # NLL is divided by the global count of supervised tokens,
            # and the aux loss (global, the same on every rank) by the
            # ranks; the shares sum to the reference's loss.
            count = grp.psum(count)
            aux = aux / grp.size
        loss = torch.sum(nll * lmask) / torch.clamp(count, min=1.0)
        return loss + aux, {"lm_loss": loss, "aux_loss": aux}

    # ---- input specs (launchers) ---------------------------------------------
    def input_specs(self, shape):
        """Stand-ins for every model input of a ``ShapeConfig`` cell, as
        tensors on the ``meta`` device with the reference's shapes and
        dtypes: train and prefill cells take tokens (B, S) int32 and the
        arch's image embeddings or encoder frames (bf16); decode cells
        one token (B, 1), its positions (B,) and a cache of S positions
        (``init_cache``: per layer, where the reference stacks each
        pattern position over super-blocks)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = torch.device("meta")

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=meta)

        if shape.kind in ("train", "prefill"):
            batch = {"tokens": spec((b, s), torch.int32)}
            if cfg.vision is not None:
                batch["img_embeds"] = spec(
                    (b, cfg.vision.n_img_tokens, cfg.vision.embed_dim),
                    torch.bfloat16)
            if cfg.is_encdec:
                batch["enc_frames"] = spec(
                    (b, cfg.encoder.src_len, cfg.d_model), torch.bfloat16)
            return batch
        return {"tokens": spec((b, 1), torch.int32),
                "pos": spec((b,), torch.int32),
                "cache": self.init_cache(b, s, device=meta)}

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, device=None):
        """Decode cache: per layer a KV cache (a ring of ``window`` slots
        for windowed attention, else ``capacity`` slots), a zero RG-LRU
        state or a zero xLSTM state; a zero ``enc_out`` for an
        encoder-decoder."""
        cfg = self.cfg
        a = cfg.attn
        adt = dtype_of(cfg.dtype)
        grp = model_group(cfg)

        def one(kind):
            if kind == "rglru":
                return init_rglru_state(batch, cfg, adt, device)
            if kind in ("mlstm", "slstm"):
                return init_xlstm_state(kind, batch, cfg, adt, device)
            window = _window(kind, a)
            cap = min(capacity, window) if window else capacity
            if grp is None:
                return init_kv_cache(batch, cap, a.n_kv_heads, a.head_dim,
                                     adt, device)
            mode, pos_split = kv_layout(cfg, cap, grp.size, grp.rows_split)
            if mode == "heads":
                return init_kv_cache(batch, cap, a.n_kv_heads // grp.size,
                                     a.head_dim, adt, device)
            if mode is None:
                return init_kv_cache(batch, cap, a.n_kv_heads, a.head_dim,
                                     adt, device)
            c = init_kv_cache(batch, cap // grp.size, a.n_kv_heads,
                              a.head_dim, adt, device)
            positions = c.positions if pos_split else torch.full(
                (batch, cap), -1, dtype=torch.int32, device=device)
            return SlotKVCache(c.k, c.v, positions)

        cache = {"layers": [one(self.kind(i)) for i in range(cfg.n_layers)],
                 "step_offset": torch.zeros((batch,), dtype=torch.int32,
                                            device=device)}
        if cfg.is_encdec:
            cache["enc_out"] = torch.zeros(
                (batch, cfg.encoder.src_len, cfg.d_model), dtype=adt,
                device=device)
        return cache

    def prefill(self, params, batch, *, max_new_tokens: int = 64):
        """Run the prompt (behind the image prefix, with the encoder's
        output), build the decode cache (with ``max_new_tokens`` of
        headroom for linear caches), return the last logits.

        The attention path follows the tensors: the flash-attention
        kernel on the card at every length; on the CPU the kernel's
        plain version (the JAX package's ``full``) up to 1024 positions
        and ``chunked`` above, as the JAX package."""
        b, s = batch["tokens"].shape
        x, enc_out = self._inputs(params, batch)
        n = x.shape[1]                                   # prefix + prompt
        cache0 = self.init_cache(b, n + max_new_tokens, device=x.device)
        # The card's path on ``meta`` tensors too (the dry run's trace).
        impl = ("chunked" if x.device.type == "cpu" and n > 1024
                else "kernel")
        x, caches, _ = self._backbone(params, x, impl=impl,
                                      cache=cache0["layers"],
                                      enc_out=enc_out)
        logits = self._logits(params, x[:, -1:])
        cache = {"layers": caches,
                 "step_offset": torch.full((b,), n, dtype=torch.int32,
                                           device=x.device)}
        if enc_out is not None:
            cache["enc_out"] = enc_out
        return logits[:, 0], cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1) int; pos: (B,) absolute positions.  Returns
        (logits (B, V), cache); the cache is updated in place (a KV
        cache's tensors, a recurrent layer's entry of
        ``cache["layers"]``)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        layers = cache["layers"]
        enc_out = cache.get("enc_out")
        for i, p in enumerate(params["layers"]):
            x, layers[i], _ = _apply_block(self.kind(i), p, x, cfg,
                                           impl=None, positions=None,
                                           cache=layers[i], pos=pos,
                                           decode=True, enc_out=enc_out)
        x = apply_norm(cfg.norm, params.get("final_norm"), x)
        return self._logits(params, x)[:, 0], cache
