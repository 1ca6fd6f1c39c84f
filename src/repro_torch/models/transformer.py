"""The decoder stack of the ported language models, in PyTorch.

``ModelConfig`` is the JAX package's config, copied whole. The stack is a
``ModuleList`` of layers (not a scanned stack of stacked parameters). Every
mixer of the JAX package is ported: ``attn`` (global GQA attention),
``attn_local`` (the same with a sliding window of ``local_window`` keys),
``mamba`` and ``rwkv``; so are the ``dense``, ``moe`` and ``moe_dense`` (a
dense MLP and the MoE layer side by side, their outputs summed) MLPs. Any
other mixer or MLP raises ``NotImplementedError`` by name. The LM runs on
one process: its MoE layers take the ``local`` dispatch (``_moe_comm_mode``
without a group); ``models.moe.moe_block`` takes a group itself.

Frontends are the JAX package's stubs: ``batch["frontend"]`` holds
precomputed embeddings [B, F, d]. A vision model (phi-3-vision) puts them in
front of the token embeddings (positions run over F + S, and ``loss_fn``
skips their logits). An encoder–decoder (seamless-m4t, ``encoder_layers``)
runs them through a bidirectional encoder (``encoder``, ``enc_norm``) whose
output every decoder layer attends to through its cross-attention
(``cross[l]``: an RMSNorm, then non-causal attention of ``h @ wq`` over the
memory ``enc_out @ wk``, ``enc_out @ wv``, with no RoPE and no bias),
between its self-attention and its MLP. Both attentions run the flash
kernel's non-causal forms on the card.

API (the JAX package's, with an explicit device and generator):
  init_params(cfg, gen=None, *, seed=0, device=None)      → LM
  forward(cfg, params, batch, *, device=None)              → logits
  loss_fn(cfg, params, batch, *, device=None)              → scalar loss
  init_cache(cfg, batch, max_len, *, device=None)          → decode cache
  prefill(cfg, params, batch, max_len, *, device=None)     → (cache, last_logits)
  decode_step(cfg, params, cache, tokens, pos, *, device=None) → (logits, cache)

``device`` goes through :func:`repro_torch.device.resolve_device`: ``cuda``
unless the caller asks for the CPU, and the parameters must live there.
``forward`` and ``loss_fn`` are differentiable: where grad mode is on and a
parameter requires grad (the trainer switches them on), each layer runs
under ``torch.utils.checkpoint`` (its activations are recomputed in the
backward, the JAX package's ``jax.checkpoint`` of a layer group) and
attention through the flash kernel's backward. ``prefill`` and
``decode_step`` run under ``torch.inference_mode()``. The decode cache has the
JAX package's layout, with G the number of layer groups: ``{"pos<p>":
{"attn": {"k", "v": [G, B, max_len, KV, hd], "len": [G] int32}}}`` for an
attention position (a local one too: ``max_len`` positions, as the JAX
package allocates, not a ring of ``local_window``), ``{"pos<p>": {"mamba":
(conv_tail [G, B, K-1, Di], h [G, B, Di, N] f32)}}`` for a Mamba one and
``{"pos<p>": {"rwkv": (x_prev [G, B, d], S [G, B, H, hd, hd])}}`` for an
RWKV one. An encoder–decoder's cache also holds ``{"memory": {"k", "v":
[L, B, enc_len, KV, hd]}}``, the cross-attention's keys and values of every
decoder layer: zeros of ``frontend_len or max_len`` frames from
``init_cache``, the frames' own from ``prefill``; a decode step attends to
all of it, as the JAX package's does. The cache is updated in place:
``decode_step`` returns the cache it was given, which saves a copy of the
whole state at every step. ``len`` lives on the host, so reading the valid
prefix of the KV cache needs no device sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.hybrid_comm import moe_dispatch_mode
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    MLP,
    Attention,
    AttnSpec,
    attention_block,
    attn_init,
    dense_init,
    dtype_of,
    empty_param,
    mlp_block,
    mlp_init,
    rmsnorm,
)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads
    # mixer / mlp patterns, cycled over layers
    layer_pattern: Tuple[str, ...] = ("attn",)          # attn | attn_local | mamba | rwkv
    mlp_pattern: Tuple[str, ...] = ("dense",)           # dense | moe | moe_dense
    # attention
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    local_window: int = 4096
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    attn_chunk: int = 512
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_comm: str = "auto"           # auto | push | pull | local
    # ssm
    ssm_state: int = 16
    ssm_conv: int = 4
    mamba_expand: int = 2
    # enc-dec
    encoder_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None   # "audio" | "vision"
    frontend_len: int = 0
    # misc
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    sub_quadratic: bool = False      # eligible for long_500k decode

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 64 so the vocab axis shards
        evenly over model=16 (padded logits are masked to -inf)."""
        return ((self.vocab_size + 63) // 64) * 64

    @property
    def period(self) -> int:
        return int(math.lcm(len(self.layer_pattern), len(self.mlp_pattern)))

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.period == 0, (self.num_layers, self.period)
        return self.num_layers // self.period

    def mixer_at(self, pos: int) -> str:
        return self.layer_pattern[pos % len(self.layer_pattern)]

    def mlp_at(self, pos: int) -> str:
        return self.mlp_pattern[pos % len(self.mlp_pattern)]

    def attn_spec(self, local: bool) -> AttnSpec:
        return AttnSpec(
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.hd,
            rope_theta=self.rope_theta,
            rope_fraction=self.rope_fraction,
            window=self.local_window if local else None,
            attn_softcap=self.attn_softcap,
            bias=self.qkv_bias,
            causal=True,
        )

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def param_count(self) -> int:
        """Analytic total parameter count (for roofline MODEL_FLOPS)."""
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        total = v * d + (0 if self.tie_embeddings else v * d)
        for l in range(self.num_layers):
            mixer = self.mixer_at(l)
            if mixer in ("attn", "attn_local"):
                total += d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
            elif mixer == "mamba":
                di = self.mamba_expand * d
                total += d * 2 * di + di * d + di * (max(1, d // 16) + 2 * self.ssm_state) + di * self.ssm_conv
            elif mixer == "rwkv":
                total += 5 * d * d + 2 * d * 64
            mlp = self.mlp_at(l)
            if mlp in ("dense",):
                total += 3 * d * ff
            if mlp in ("moe", "moe_dense"):
                total += 3 * d * self.moe_d_ff * self.num_experts + d * self.num_experts
            if mlp == "moe_dense":
                total += 3 * d * ff
        if self.encoder_layers:
            # encoder self-attn + mlp + decoder cross-attn
            total += self.encoder_layers * (
                d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d + 3 * d * ff
            )
            total += self.num_layers * (d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers_moe() * 3 * d * self.moe_d_ff * self.num_experts
        return dense + self.num_layers_moe() * 3 * d * self.moe_d_ff * self.experts_per_token

    def num_layers_moe(self) -> int:
        return sum(1 for l in range(self.num_layers) if self.mlp_at(l) in ("moe", "moe_dense"))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

ATTN_MIXERS = ("attn", "attn_local")
MIXERS = ATTN_MIXERS + ("mamba", "rwkv")
MLPS = ("dense", "moe", "moe_dense")


def _check_ported(cfg: ModelConfig, layer: int) -> None:
    mixer, mlp = cfg.mixer_at(layer), cfg.mlp_at(layer)
    if mixer not in MIXERS:
        raise NotImplementedError(f"mixer {mixer!r} (layer {layer} of {cfg.name}) is not ported")
    if mlp not in MLPS:
        raise NotImplementedError(f"mlp {mlp!r} (layer {layer} of {cfg.name}) is not ported")


class Block(nn.Module):
    """One layer: ln1 → mixer → residual, ln2 → MLP → residual. The MLP is
    ``mlp`` (dense), ``moe`` or both (``moe_dense``)."""

    def __init__(self, cfg: ModelConfig, layer: int, device=None):
        super().__init__()
        _check_ported(cfg, layer)
        dt = dtype_of(cfg.dtype)
        self.mixer = cfg.mixer_at(layer)
        # An attention layer's spec (a local one's carries the window), fixed here.
        self.spec = (cfg.attn_spec(self.mixer == "attn_local") if self.mixer in ATTN_MIXERS
                     else None)
        self.ln1 = empty_param((cfg.d_model,), torch.float32, device)
        self.ln2 = empty_param((cfg.d_model,), torch.float32, device)
        if self.spec is not None:
            self.attn = Attention(cfg.d_model, self.spec, dt, device)
        elif self.mixer == "mamba":
            self.mamba = ssm_mod.Mamba(cfg.d_model, dt, expand=cfg.mamba_expand,
                                       state=cfg.ssm_state, conv_dim=cfg.ssm_conv, device=device)
        else:
            self.rwkv = ssm_mod.RWKV6(cfg.d_model, cfg.num_heads, dt, device=device)
        kind = cfg.mlp_at(layer)
        if kind in ("dense", "moe_dense"):
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)
        if kind in ("moe", "moe_dense"):
            self.moe = moe_mod.MoE(cfg.d_model, cfg.moe_d_ff, cfg.num_experts, dt, device)


def encoder_spec(cfg: ModelConfig) -> AttnSpec:
    """The encoder's self-attention and the decoder's cross-attention:
    global, non-causal."""
    return dataclasses.replace(cfg.attn_spec(False), causal=False)


class EncoderBlock(nn.Module):
    """One encoder layer: ln1 → bidirectional attention → residual, ln2 →
    dense MLP → residual."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.ln1 = empty_param((cfg.d_model,), torch.float32, device)
        self.ln2 = empty_param((cfg.d_model,), torch.float32, device)
        self.attn = Attention(cfg.d_model, encoder_spec(cfg), dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class CrossBlock(nn.Module):
    """A decoder layer's cross-attention: ln [d] f32 and its projections (of
    which it reads wq, wk, wv and wo)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = empty_param((cfg.d_model,), torch.float32, device)
        self.attn = Attention(cfg.d_model, encoder_spec(cfg), dtype_of(cfg.dtype), device)


class LM(nn.Module):
    """The decoder: embed [vocab_padded, d], ``blocks`` (one per layer, layer
    ``g * period + pos`` being group g's position pos), final_norm [d] f32,
    lm_head [d, vocab_padded] unless the embeddings are tied; with
    ``encoder_layers`` also ``encoder`` (that many ``EncoderBlock``s),
    enc_norm [d] f32 and ``cross`` (a ``CrossBlock`` per decoder layer). The
    parameters are allocated uninitialised; ``init_params`` and ``convert``
    fill them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        self.cfg = cfg
        self.embed = empty_param((cfg.vocab_padded, cfg.d_model), dt, device)
        self.blocks = nn.ModuleList(Block(cfg, l, device) for l in range(cfg.num_layers))
        self.final_norm = empty_param((cfg.d_model,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((cfg.d_model, cfg.vocab_padded), dt, device)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(EncoderBlock(cfg, device)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = empty_param((cfg.d_model,), torch.float32, device)
            self.cross = nn.ModuleList(CrossBlock(cfg, device) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator] = None, *, seed: int = 0,
                device=None) -> LM:
    """Random parameters with the JAX package's shapes, scales and dtypes,
    drawn from ``gen`` (default: a generator on ``device`` seeded with
    ``seed``). The numbers differ from ``jax.random``'s; the tests carry the
    JAX package's parameters across with ``convert.from_jax_params``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    if torch.device(gen.device).type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters asked on {dev}")
    dt = dtype_of(cfg.dtype)
    lm = LM(cfg, dev)
    for blk in lm.blocks:
        blk.ln1.zero_()
        blk.ln2.zero_()
        if blk.spec is not None:
            blk.attn = attn_init(gen, cfg.d_model, blk.spec, dt)
        elif blk.mixer == "mamba":
            blk.mamba = ssm_mod.mamba_init(gen, cfg.d_model, expand=cfg.mamba_expand,
                                           state=cfg.ssm_state, conv_dim=cfg.ssm_conv, dtype=dt)
        else:
            blk.rwkv = ssm_mod.rwkv6_init(gen, cfg.d_model, cfg.num_heads, dtype=dt)
        if hasattr(blk, "mlp"):
            blk.mlp = mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
        if hasattr(blk, "moe"):
            blk.moe = moe_mod.moe_init(gen, cfg.d_model, cfg.moe_d_ff, cfg.num_experts, dt)
    lm.embed.copy_(dense_init(gen, (cfg.vocab_padded, cfg.d_model), dt, scale=0.02))
    lm.final_norm.zero_()
    if not cfg.tie_embeddings:
        lm.lm_head.copy_(dense_init(gen, (cfg.d_model, cfg.vocab_padded), dt))
    if cfg.encoder_layers:
        spec = encoder_spec(cfg)
        for enc in lm.encoder:
            enc.ln1.zero_()
            enc.ln2.zero_()
            enc.attn = attn_init(gen, cfg.d_model, spec, dt)
            enc.mlp = mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
        lm.enc_norm.zero_()
        for xa in lm.cross:
            xa.ln.zero_()
            xa.attn = attn_init(gen, cfg.d_model, spec, dt)
    return lm


def params_device(params: LM, device) -> torch.device:
    dev = resolve_device(device)
    if params.device.type != dev.type or (dev.index is not None and params.device != dev):
        raise ValueError(f"parameters live on {params.device}, asked to run on {dev}")
    return params.device


def _tokens(tokens, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=dev).to(torch.int64)


def _frontend(cfg: ModelConfig, batch: Dict, dev: torch.device) -> Optional[torch.Tensor]:
    """``batch["frontend"]`` [B, F, d] (a tensor or a numpy array) in the
    model dtype; None if absent. An encoder–decoder without it raises
    ``ValueError``: its decoder has no frames to attend to (the JAX package
    fails there too, by an assertion in ``forward`` and a ``KeyError`` in
    ``prefill``)."""
    emb = batch.get("frontend")
    if emb is None:
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.name} is an encoder–decoder: batch['frontend'] must hold "
                             f"its encoder's input frames [B, frames, {cfg.d_model}]")
        return None
    return torch.as_tensor(emb, device=dev).to(dtype_of(cfg.dtype))


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
           frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled token embeddings, behind the frontend's embeddings unless the
    frontend feeds an encoder (``family == "audio"``)."""
    x = params.embed[torch.clamp(tokens, 0, cfg.vocab_size - 1)] * (cfg.d_model ** 0.5)
    x = x.to(dtype_of(cfg.dtype))
    if frontend is not None and cfg.family != "audio":
        x = torch.cat([frontend, x], dim=1)
    return x


def _logits(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    if cfg.logit_softcap is not None and logits.requires_grad:
        # tanh's backward reads its output: no in-place step after it.
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    elif cfg.logit_softcap is not None:
        # cap * tanh(logits / cap), each op rounded as JAX rounds it, in place:
        # gemma2's [B, S, 256000] logits take no second and third copy.
        logits = logits.div_(cfg.logit_softcap).tanh_().mul_(cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                       device=logits.device))
    return logits


def _positions(start: int, s: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(start, start + s, device=dev)[None]  # [1, S], broadcast over B


def _moe_comm_mode(cfg: ModelConfig, tokens_per_step: int, comm=None) -> str:
    """The MoE dispatch of a pass of ``tokens_per_step`` tokens: the
    config's, unless ``auto``; with no group or a group of one ``local``;
    else ``moe_dispatch_mode``'s Eq.-3 choice over the group's ranks."""
    if cfg.moe_comm != "auto":
        return cfg.moe_comm
    dp = 1 if comm is None else comm.world_size
    if dp <= 1:
        return "local"
    return moe_dispatch_mode(
        tokens_per_step=tokens_per_step, d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
        num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
        dp_degree=dp,
    ).mode


def _recompute(params: LM) -> bool:
    """Whether a pass builds a graph for a backward: grad mode on and the
    parameters trainable. Such a pass recomputes each layer in the backward."""
    return torch.is_grad_enabled() and params.embed.requires_grad


def _encoder_layer(cfg: ModelConfig, enc: EncoderBlock, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, enc.ln1, cfg.norm_eps)
    att, _ = attention_block(enc.attn, h, encoder_spec(cfg), positions, None,
                             chunk=cfg.attn_chunk)
    x = x + att
    return x + mlp_block(enc.mlp, rmsnorm(x, enc.ln2, cfg.norm_eps))


def _encode(cfg: ModelConfig, params: LM, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over the frames [B, S_enc, d] (model dtype): bidirectional
    self-attention with RoPE over ``arange(S_enc)``, then the MLP, in each
    layer (recomputed in the backward of a training pass); then ``enc_norm``."""
    x = frames
    positions = _positions(0, x.shape[1], x.device)
    recompute = _recompute(params)
    for enc in params.encoder:
        x = checkpoint(_encoder_layer, cfg, enc, x, positions, use_reentrant=False) \
            if recompute else _encoder_layer(cfg, enc, x, positions)
    return rmsnorm(x, params.enc_norm, cfg.norm_eps)


def _memory_kv(cfg: ModelConfig, xa: CrossBlock, enc_out: torch.Tensor):
    """One decoder layer's cross-attention memory: (k, v) [B, S_enc, KV, hd],
    ``enc_out @ wk`` and ``enc_out @ wv`` (no RoPE, no bias)."""
    b, s, _ = enc_out.shape
    return ((enc_out @ xa.attn.wk).view(b, s, cfg.num_kv_heads, cfg.hd),
            (enc_out @ xa.attn.wv).view(b, s, cfg.num_kv_heads, cfg.hd))


def _cross_attention(cfg: ModelConfig, xa: CrossBlock, h: torch.Tensor, mem_k: torch.Tensor,
                     mem_v: torch.Tensor) -> torch.Tensor:
    """Decoder → encoder attention: q = ``h @ wq`` (no RoPE, no bias) over
    every memory frame, non-causal (the flash kernel's ``causal=False``); the
    CPU path walks the memory in the JAX package's default chunks of 512."""
    spec = encoder_spec(cfg)
    b, s, _ = h.shape
    q = (h @ xa.attn.wq).view(b, s, spec.num_heads, spec.head_dim)
    out = attn_ops.attention(q.transpose(1, 2), mem_k.transpose(1, 2), mem_v.transpose(1, 2),
                             causal=False, softcap=spec.attn_softcap)
    return out.transpose(1, 2).reshape(b, s, spec.num_heads * spec.head_dim) @ xa.attn.wo


def _apply_layer(cfg: ModelConfig, blk: Block, x: torch.Tensor, positions: torch.Tensor,
                 state=None, cross=None):
    """One decoder layer: the mixer, then (``cross`` = (CrossBlock, k, v) of
    an encoder–decoder) the cross-attention, then the MLP."""
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    if blk.spec is not None:
        y, new_state = attention_block(blk.attn, h, blk.spec, positions, state,
                                       chunk=cfg.attn_chunk)
    elif blk.mixer == "mamba":
        y, new_state = ssm_mod.mamba_block(blk.mamba, h, state)
    else:
        y, new_state = ssm_mod.rwkv6_block(blk.rwkv, h, cfg.num_heads, state)
    x = x + y
    if cross is not None:
        xa, mem_k, mem_v = cross
        x = x + _cross_attention(cfg, xa, rmsnorm(x, xa.ln, cfg.norm_eps), mem_k, mem_v)
    h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
    delta = mlp_block(blk.mlp, h2) if hasattr(blk, "mlp") else None
    if hasattr(blk, "moe"):  # in the model dtype: the dense MLP's output first
        m = moe_mod.moe_block(blk.moe, h2, experts_per_token=cfg.experts_per_token,
                              comm_mode=_moe_comm_mode(cfg, h2.shape[0] * h2.shape[1]))
        delta = m if delta is None else delta + m
    return x + delta, new_state


def _decoder_layer(cfg: ModelConfig, blk: Block, x: torch.Tensor, positions: torch.Tensor,
                   xa: Optional[CrossBlock], enc_out: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer of a full pass; an encoder–decoder's memory of this layer is
    made here, where it is read (and recomputed with the layer)."""
    cross = None if xa is None else (xa, *_memory_kv(cfg, xa, enc_out))
    return _apply_layer(cfg, blk, x, positions, cross=cross)[0]


def forward(cfg: ModelConfig, params: LM, batch: Dict, *, device=None) -> torch.Tensor:
    """tokens [B, S] (and ``frontend`` [B, F, d]) → logits [B, S', vocab_padded]
    in the model dtype: S' = F + S for a vision frontend, else S.
    Differentiable (each layer recomputed in the backward) where grad mode is
    on and the parameters require grad."""
    dev = params_device(params, device)
    frontend = _frontend(cfg, batch, dev)
    x = _embed(cfg, params, _tokens(batch["tokens"], dev), frontend)
    positions = _positions(0, x.shape[1], dev)
    enc_out = _encode(cfg, params, frontend) if cfg.encoder_layers else None
    recompute = _recompute(params)
    for layer, blk in enumerate(params.blocks):
        xa = params.cross[layer] if enc_out is not None else None
        x = checkpoint(_decoder_layer, cfg, blk, x, positions, xa, enc_out,
                       use_reentrant=False) if recompute \
            else _decoder_layer(cfg, blk, x, positions, xa, enc_out)
    return _logits(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: LM, batch: Dict, *, device=None) -> torch.Tensor:
    """Mean next-token cross-entropy (float32) over the text positions (a
    vision frontend's are skipped), under ``loss_mask`` if given."""
    logits = forward(cfg, params, batch, device=device)
    tokens = _tokens(batch["tokens"], logits.device)
    front = 0
    if batch.get("frontend") is not None and cfg.family != "audio" and not cfg.encoder_layers:
        front = batch["frontend"].shape[1]
    preds = logits[:, front:-1, :].to(torch.float32)
    logz = torch.logsumexp(preds, dim=-1)
    gold = torch.gather(preds, -1, tokens[:, 1:, None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else \
        torch.as_tensor(mask, device=nll.device)[:, 1:].to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, batch: int, max_len: int, dev: torch.device) -> Dict:
    """Zero decode state of every pattern position (``{"pos<p>": ...}``)."""
    dt = dtype_of(cfg.dtype)
    ng = cfg.num_groups
    cache = {}
    for pos in range(cfg.period):
        _check_ported(cfg, pos)
        if cfg.mixer_at(pos) in ATTN_MIXERS:
            shape = (ng, batch, max_len, cfg.num_kv_heads, cfg.hd)
            cache[f"pos{pos}"] = {"attn": {
                "k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "len": torch.zeros((ng,), dtype=torch.int32),
            }}
            continue
        if cfg.mixer_at(pos) == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            cache[f"pos{pos}"] = {"mamba": (
                torch.zeros((ng, batch, cfg.ssm_conv - 1, di), dtype=dt, device=dev),
                torch.zeros((ng, batch, di, cfg.ssm_state), dtype=torch.float32, device=dev),
            )}
            continue
        hd = cfg.d_model // cfg.num_heads
        cache[f"pos{pos}"] = {"rwkv": (
            torch.zeros((ng, batch, cfg.d_model), dtype=dt, device=dev),
            torch.zeros((ng, batch, cfg.num_heads, hd, hd), dtype=torch.float32, device=dev),
        )}
    return cache


def _memory(cfg: ModelConfig, batch: int, enc_len: int, dev: torch.device) -> Dict:
    """Zero cross-attention memory {"k", "v": [L, B, enc_len, KV, hd]}."""
    shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, cfg.hd)
    dt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> Dict[str, Any]:
    """Zero decode state for ``batch`` sequences: a KV cache of ``max_len``
    positions for each attention layer (Mamba's and RWKV's states do not
    grow with the sequence) and, for an encoder–decoder, a zero memory of
    ``frontend_len or max_len`` frames."""
    dev = resolve_device(device)
    cache = _layer_cache(cfg, batch, max_len, dev)
    if cfg.encoder_layers:
        cache["memory"] = _memory(cfg, batch, cfg.frontend_len or max_len, dev)
    return cache


def _cache_len(cfg: ModelConfig, cache: Dict) -> Optional[int]:
    """Tokens held by the KV cache (None for a model without attention)."""
    for pos in range(cfg.period):
        entry = cache[f"pos{pos}"]
        if "attn" in entry:
            return int(entry["attn"]["len"][0])
    return None


def _run_with_cache(cfg: ModelConfig, params: LM, x: torch.Tensor, positions: torch.Tensor,
                    cache: Dict) -> torch.Tensor:
    memory = cache.get("memory") if cfg.encoder_layers else None
    for layer, blk in enumerate(params.blocks):
        g, pos = divmod(layer, cfg.period)
        entry = cache[f"pos{pos}"]
        cross = None if memory is None else \
            (params.cross[layer], memory["k"][layer], memory["v"][layer])
        if blk.spec is not None:
            kv = entry["attn"]
            x, new = _apply_layer(cfg, blk, x, positions, {
                "k": kv["k"][g], "v": kv["v"][g], "len": int(kv["len"][g])}, cross)
            kv["len"][g] = new["len"]
            continue
        # Mamba's (conv tail, h) or RWKV's (x_prev, S), updated in place.
        first, second = entry[blk.mixer]
        x, (new_first, new_second) = _apply_layer(cfg, blk, x, positions,
                                                  (first[g], second[g]), cross)
        first[g].copy_(new_first)
        second[g].copy_(new_second)
    return x


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: LM, batch: Dict, max_len: int, *,
            device=None) -> Tuple[Dict, torch.Tensor]:
    """Run the prompt [B, S] (behind or beside ``batch["frontend"]``) from a
    fresh cache → (cache, logits [B, 1, V]). An encoder–decoder's memory is
    its frames' keys and values; a vision prompt fills F + S positions."""
    dev = params_device(params, device)
    tokens = _tokens(batch["tokens"], dev)
    frontend = _frontend(cfg, batch, dev)
    b = tokens.shape[0]
    cache = _layer_cache(cfg, b, max_len, dev)
    if cfg.encoder_layers:
        enc_out = _encode(cfg, params, frontend)
        cache["memory"] = mem = _memory(cfg, b, enc_out.shape[1], dev)
        for layer, xa in enumerate(params.cross):
            mem["k"][layer], mem["v"][layer] = _memory_kv(cfg, xa, enc_out)
    x = _embed(cfg, params, tokens, frontend)
    x = _run_with_cache(cfg, params, x, _positions(0, x.shape[1], dev), cache)
    return cache, _logits(cfg, params, x[:, -1:, :])


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: LM, cache: Dict, tokens, pos=None, *,
                device=None) -> Tuple[torch.Tensor, Dict]:
    """tokens [B, 1] → (logits [B, 1, V], cache). ``pos`` is the new token's
    position (after a vision prefill F + S). With attention layers it must
    equal the KV cache's length, else ``ValueError``: the kernel places the
    query on the diagonal after the cached keys, where the JAX package masks
    by ``pos`` itself, and the two agree only there (the JAX server never
    passes another). Mamba and RWKV do not need it. An encoder–decoder
    attends to the cache's whole memory."""
    dev = params_device(params, device)
    length = _cache_len(cfg, cache)
    if length is not None and pos is not None and int(pos) != length:
        raise ValueError(f"decode_step: position {int(pos)} is not the KV cache's length "
                         f"{length}")
    start = length if length is not None else 0
    x = _run_with_cache(cfg, params, _embed(cfg, params, _tokens(tokens, dev)),
                        _positions(start, 1, dev), cache)
    return _logits(cfg, params, x), cache
