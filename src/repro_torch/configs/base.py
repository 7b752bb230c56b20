"""Model / run configuration for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``. A config is a
pure dataclass — no jax imports, no device state — so importing a config never
touches the runtime. Layer stacking is expressed as a repeating ``pattern`` of
``BlockSpec``s scanned ``n_groups`` times (``pattern * n_groups`` == the full
layer stack). Homogeneous models use a length-1 pattern; interleaved models
(Jamba 1:7 mamba:attn, Llama-vision self/cross) use longer patterns.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


# --------------------------------------------------------------------------
# Block specs
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSpec:
    """One layer position inside the repeating pattern."""

    mixer: str = "attn"          # attn | cross_attn | mamba | rwkv6
    ffn: str = "dense"           # dense | moe | none
    parallel: bool = False       # Cohere-style parallel attn+ffn off one norm


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 16
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64         # lora rank for the data-dependent decay
    gate_lora: int = 0           # 0 -> d_model // 2 is NOT used; plain gate proj


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int                  # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                     # per-expert width for MoE archs
    vocab_size: int
    pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    d_head: int = 0               # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # vlm / audio frontend stubs
    n_ctx_tokens: int = 0         # cross-attn context length (image patches)
    frontend: str = "tokens"      # tokens | frames (precomputed embeddings)
    # misc
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 16  # pad vocab so the parallel head divides TP
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"          # none | block | full
    optimizer: str = "adamw"      # adamw | adafactor (memory-lean for >90B)
    attn_chunk: int = 0           # 0 -> auto: chunked attention when S > 8192
    kv_update: str = "onehot"     # onehot | dus (vmap dynamic_update_slice)
    decode_return: str = "logits"  # logits | token (vocab-parallel argmax)
    serve_fsdp: bool = True       # False: serve steps drop FSDP (TP-only
    #                               params; kills per-step weight gathers)
    moe_shard: str = "expert"     # expert (EP over model) | ffn (per-expert
    #                               TP over d_ff; dispatch stays device-local)
    attn_seq_shard: bool = False  # shard attention scores over q-sequence
    #                               on the model axis (context parallelism)
    kv_shard: str = "seq"         # decode KV-cache layout: seq (flash-
    #                               decoding over model) | batch (per-example
    #                               local attention; no model-axis gathers)
    fsdp_dim: str = "contract"    # contract: shard weights on contraction
    #                               dims (partial sums -> activation-sized
    #                               all-reduces — the measured pathology) |
    #                               output: ZeRO-3 style — weights sharded on
    #                               output dims, gathered just-in-time
    decode_attn: str = "auto"     # auto (XLA decides; reshards the cache) |
    #                               flashdecode (q replicated, scores stay
    #                               seq-sharded, LSE-merge over 'model')
    # distribution hints
    fsdp: bool = False            # additionally shard params over the data axis
    vocab_parallel: bool = True   # shard_map vocab-parallel embed + CE
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (quantized KV feature)

    # The port's options beyond the JAX package's config. They are fields
    # of ``PortConfig`` alone, so that ``dataclasses.asdict`` of every
    # preset stays the JAX package's; on a ``ModelConfig`` they read
    # today's behaviour.
    attn_rope = True              # False: self-attention without positions
    mamba_inner_norms = False     # RMSNorms on x_proj's dt, B and C splits
    moe_renormalize = True        # False: the top-k softmax weights as
    #                               they are, not divided by their sum
    moe_held = 0                  # experts held here (0: all n_experts), a
    moe_held_offset = 0           # contiguous block from this one; the
    #                               router still routes over n_experts

    # ---------------- derived ----------------
    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.arch_id}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )

    @property
    def n_held(self) -> int:
        """The MoE experts this chip holds (of ``moe.n_experts``)."""
        return self.moe_held or self.moe.n_experts

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return all(b.mixer in ("mamba", "rwkv6") for b in self.pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM / hybrid)."""
        return any(b.mixer in ("mamba", "rwkv6") for b in self.pattern)

    # ---------------- parameter counting (for rooflines) ----------------
    def param_counts(self) -> dict[str, float]:
        """Analytic parameter counts: total and active-per-token."""
        D, H, KV, Dh, F = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.d_head, self.d_ff)
        embed = self.padded_vocab * D
        head = 0 if self.tie_embeddings else self.padded_vocab * D
        total = embed + head + 2 * D  # final norm (scale) + small slack
        active = float(embed // max(self.padded_vocab, 1)) * 0  # embed gather is O(D)
        per_layer_total = 0.0
        per_layer_active = 0.0
        counts = {"attn": 0, "cross_attn": 0, "mamba": 0, "rwkv6": 0}
        for blk in self.pattern:
            counts[blk.mixer] += 1
            if blk.mixer in ("attn", "cross_attn"):
                p = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
            elif blk.mixer == "mamba":
                mc = self.mamba or MambaConfig()
                d_in = mc.expand * D
                dt_rank = mc.dt_rank or -(-D // 16)
                p = (D * 2 * d_in               # in_proj (x and z)
                     + d_in * mc.d_conv         # depthwise conv
                     + d_in * (dt_rank + 2 * mc.d_state)  # x_proj
                     + dt_rank * d_in           # dt_proj
                     + d_in * mc.d_state        # A
                     + d_in                     # D skip
                     + d_in * D)                # out_proj
            elif blk.mixer == "rwkv6":
                rc = self.rwkv or RWKVConfig()
                p = 5 * D * D + D * rc.decay_lora * 2 + D * D  # r,k,v,g,o + w lora + out
            else:
                raise ValueError(blk.mixer)
            per_layer_total += p
            per_layer_active += p
            # norms
            per_layer_total += 2 * D
            per_layer_active += 2 * D
            if blk.ffn == "dense":
                f = 3 * D * F  # swiglu
                per_layer_total += f
                per_layer_active += f
            elif blk.ffn == "cmix":
                f = D * D + 2 * D * F  # rwkv channel mix: r gate + k/v
                per_layer_total += f
                per_layer_active += f
            elif blk.ffn == "moe":
                moe = self.moe or MoEConfig()
                f = 3 * D * F
                per_layer_total += moe.n_experts * f + D * moe.n_experts
                per_layer_active += moe.top_k * f + D * moe.n_experts
        total += per_layer_total * self.n_groups
        active_total = (embed // max(self.padded_vocab, 1)) + head / max(self.padded_vocab, 1)
        active = per_layer_active * self.n_groups + D  # + head row cost is per-token
        # head matmul is always dense over vocab:
        active += head if head else embed  # logits matmul touches V*D
        return {"total": float(total), "active": float(active)}

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 4),
                                      top_k=min(moe.top_k, 2))
        mamba = self.mamba
        if mamba is not None:
            mamba = dataclasses.replace(mamba, d_state=4, d_conv=4, expand=2)
        rwkv = self.rwkv
        if rwkv is not None:
            rwkv = dataclasses.replace(rwkv, head_size=8, decay_lora=4)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2)) if self.n_kv_heads else 0
        d_head = 8
        d_model = max(n_heads, 1) * d_head if n_heads else 32
        if self.rwkv is not None:
            d_model = 4 * rwkv.head_size  # 4 rwkv heads
        small = dict(
            n_layers=2 * len(self.pattern),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_head if n_heads else 0,
            d_ff=64,
            vocab_size=128,
            moe=moe,
            mamba=mamba,
            rwkv=rwkv,
            n_ctx_tokens=16 if self.n_ctx_tokens else 0,
            vocab_pad_multiple=1,
            remat="none",
            fsdp=False,
            vocab_parallel=False,
        )
        small.update(over)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A ``ModelConfig`` with the port's options as fields (defaults:
    today's behaviour), for a model the JAX package does not compute."""

    attn_rope: bool = True
    mamba_inner_norms: bool = False
    moe_renormalize: bool = True
    moe_held: int = 0
    moe_held_offset: int = 0


# --------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM family)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs. long_500k needs sub-quadratic attn."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "SKIP(full-attention): 500k decode needs sub-quadratic mixing"
    return True, ""
