"""The decoder stack of the ported language models, in PyTorch.

``ModelConfig`` is the JAX package's config, copied whole. The stack is a
``ModuleList`` of layers (not a scanned stack of stacked parameters); only
``attn`` (global GQA attention), ``attn_local`` (the same with a sliding
window of ``local_window`` keys) and ``rwkv`` mixers and ``dense``, ``moe``
and ``moe_dense`` (a dense MLP and the MoE layer side by side, their outputs
summed) MLPs are ported, and any other mixer raises ``NotImplementedError``
by name. The LM runs on one process: its MoE layers take the ``local``
dispatch (``_moe_comm_mode`` without a group); ``models.moe.moe_block``
takes a group itself.

API (the JAX package's, with an explicit device and generator):
  init_params(cfg, gen=None, *, seed=0, device=None)      → LM
  forward(cfg, params, batch, *, device=None)              → logits
  loss_fn(cfg, params, batch, *, device=None)              → scalar loss
  init_cache(cfg, batch, max_len, *, device=None)          → decode cache
  prefill(cfg, params, batch, max_len, *, device=None)     → (cache, last_logits)
  decode_step(cfg, params, cache, tokens, pos, *, device=None) → (logits, cache)

``device`` goes through :func:`repro_torch.device.resolve_device`: ``cuda``
unless the caller asks for the CPU, and the parameters must live there.
Everything runs under ``torch.inference_mode()``. The decode cache has the
JAX package's layout, with G the number of layer groups: ``{"pos<p>":
{"attn": {"k", "v": [G, B, max_len, KV, hd], "len": [G] int32}}}`` for an
attention position (a local one too: ``max_len`` positions, as the JAX
package allocates, not a ring of ``local_window``) and ``{"pos<p>":
{"rwkv": (x_prev [G, B, d], S [G, B, H, hd, hd])}}`` for an RWKV one. It
is updated in place: ``decode_step`` returns the cache it was given, which
saves a copy of the whole state at every step. ``len`` lives on the host, so
reading the valid prefix of the KV cache needs no device sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.hybrid_comm import moe_dispatch_mode
from repro_torch.device import resolve_device
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
MLPS = ("dense", "moe", "moe_dense")


def _check_ported(cfg: ModelConfig, layer: int) -> None:
    mixer, mlp = cfg.mixer_at(layer), cfg.mlp_at(layer)
    if mixer not in ATTN_MIXERS + ("rwkv",):
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
        else:
            self.rwkv = ssm_mod.RWKV6(cfg.d_model, cfg.num_heads, dt, device=device)
        kind = cfg.mlp_at(layer)
        if kind in ("dense", "moe_dense"):
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)
        if kind in ("moe", "moe_dense"):
            self.moe = moe_mod.MoE(cfg.d_model, cfg.moe_d_ff, cfg.num_experts, dt, device)


class LM(nn.Module):
    """The decoder: embed [vocab_padded, d], ``blocks`` (one per layer, layer
    ``g * period + pos`` being group g's position pos), final_norm [d] f32,
    lm_head [d, vocab_padded] unless the embeddings are tied. The parameters
    are allocated uninitialised; ``init_params`` and ``convert`` fill them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.encoder_layers or cfg.frontend:
            raise NotImplementedError(f"{cfg.family} frontends/encoders are not ported")
        dt = dtype_of(cfg.dtype)
        self.cfg = cfg
        self.embed = empty_param((cfg.vocab_padded, cfg.d_model), dt, device)
        self.blocks = nn.ModuleList(Block(cfg, l, device) for l in range(cfg.num_layers))
        self.final_norm = empty_param((cfg.d_model,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((cfg.d_model, cfg.vocab_padded), dt, device)

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
    return lm


def params_device(params: LM, device) -> torch.device:
    dev = resolve_device(device)
    if params.device.type != dev.type or (dev.index is not None and params.device != dev):
        raise ValueError(f"parameters live on {params.device}, asked to run on {dev}")
    return params.device


def _tokens(tokens, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=dev).to(torch.int64)


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    x = params.embed[torch.clamp(tokens, 0, cfg.vocab_size - 1)] * (cfg.d_model ** 0.5)
    return x.to(dtype_of(cfg.dtype))


def _logits(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    if cfg.logit_softcap is not None:
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


def _apply_layer(cfg: ModelConfig, blk: Block, x: torch.Tensor, positions: torch.Tensor,
                 state=None):
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    if blk.spec is not None:
        y, new_state = attention_block(blk.attn, h, blk.spec, positions, state,
                                       chunk=cfg.attn_chunk)
    else:
        y, new_state = ssm_mod.rwkv6_block(blk.rwkv, h, cfg.num_heads, state)
    x = x + y
    h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
    delta = mlp_block(blk.mlp, h2) if hasattr(blk, "mlp") else None
    if hasattr(blk, "moe"):  # in the model dtype: the dense MLP's output first
        m = moe_mod.moe_block(blk.moe, h2, experts_per_token=cfg.experts_per_token,
                              comm_mode=_moe_comm_mode(cfg, h2.shape[0] * h2.shape[1]))
        delta = m if delta is None else delta + m
    return x + delta, new_state


@torch.inference_mode()
def forward(cfg: ModelConfig, params: LM, batch: Dict, *, device=None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, vocab_padded] in the model dtype."""
    if batch.get("frontend") is not None:
        raise NotImplementedError("frontend embeddings are not ported")
    dev = params_device(params, device)
    x = _embed(cfg, params, _tokens(batch["tokens"], dev))
    positions = _positions(0, x.shape[1], dev)
    for blk in params.blocks:
        x, _ = _apply_layer(cfg, blk, x, positions)
    return _logits(cfg, params, x)


@torch.inference_mode()
def loss_fn(cfg: ModelConfig, params: LM, batch: Dict, *, device=None) -> torch.Tensor:
    """Mean next-token cross-entropy (float32), under ``loss_mask`` if given."""
    logits = forward(cfg, params, batch, device=device)
    tokens = _tokens(batch["tokens"], logits.device)
    preds = logits[:, :-1, :].to(torch.float32)
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

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> Dict[str, Any]:
    """Zero decode state for ``batch`` sequences: a KV cache of ``max_len``
    positions for each attention layer; RWKV's state does not grow with the
    sequence."""
    dev = resolve_device(device)
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
        hd = cfg.d_model // cfg.num_heads
        cache[f"pos{pos}"] = {"rwkv": (
            torch.zeros((ng, batch, cfg.d_model), dtype=dt, device=dev),
            torch.zeros((ng, batch, cfg.num_heads, hd, hd), dtype=torch.float32, device=dev),
        )}
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
    for layer, blk in enumerate(params.blocks):
        g, pos = divmod(layer, cfg.period)
        entry = cache[f"pos{pos}"]
        if blk.spec is not None:
            kv = entry["attn"]
            x, new = _apply_layer(cfg, blk, x, positions, {
                "k": kv["k"][g], "v": kv["v"][g], "len": int(kv["len"][g])})
            kv["len"][g] = new["len"]
            continue
        x_prev, s = entry["rwkv"]
        x, (new_prev, new_s) = _apply_layer(cfg, blk, x, positions, (x_prev[g], s[g]))
        x_prev[g].copy_(new_prev)
        s[g].copy_(new_s)
    return x


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: LM, batch: Dict, max_len: int, *,
            device=None) -> Tuple[Dict, torch.Tensor]:
    """Run the prompt [B, S] from a fresh cache → (cache, logits [B, 1, V])."""
    dev = params_device(params, device)
    tokens = _tokens(batch["tokens"], dev)
    cache = init_cache(cfg, tokens.shape[0], max_len, device=dev)
    x = _run_with_cache(cfg, params, _embed(cfg, params, tokens),
                        _positions(0, tokens.shape[1], dev), cache)
    return cache, _logits(cfg, params, x[:, -1:, :])


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: LM, cache: Dict, tokens, pos=None, *,
                device=None) -> Tuple[torch.Tensor, Dict]:
    """tokens [B, 1] → (logits [B, 1, V], cache). ``pos`` is the new token's
    position. With attention layers it must equal the KV cache's length,
    else ``ValueError``: the kernel places the query on the diagonal after
    the cached keys, where the JAX package masks by ``pos`` itself, and the
    two agree only there (the JAX server never passes another). RWKV does not
    need it."""
    dev = params_device(params, device)
    length = _cache_len(cfg, cache)
    if length is not None and pos is not None and int(pos) != length:
        raise ValueError(f"decode_step: position {int(pos)} is not the KV cache's length "
                         f"{length}")
    start = length if length is not None else 0
    x = _run_with_cache(cfg, params, _embed(cfg, params, _tokens(tokens, dev)),
                        _positions(start, 1, dev), cache)
    return _logits(cfg, params, x), cache
