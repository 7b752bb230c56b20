"""musicgen-large — 48L d_model=2048 32H (GQA kv=32 == MHA) d_ff=8192
vocab=2048 (EnCodec codebook). Decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (batch, seq, d_model); the backbone predicts
codebook tokens over the 2048-entry vocab.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(BlockSpec(mixer="attn"),),
    frontend="frames",
    rope_theta=10_000.0,
    fsdp=True,
    optimizer="adamw",
)
