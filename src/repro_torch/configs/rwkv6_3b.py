"""rwkv6-3b (Finch) — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Data-dependent decay linear recurrence. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import BlockSpec, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    pattern=(BlockSpec(mixer="rwkv6", ffn="cmix"),),
    rwkv=RWKVConfig(head_size=64, decay_lora=64),
    fsdp=True,
    optimizer="adamw",
)
