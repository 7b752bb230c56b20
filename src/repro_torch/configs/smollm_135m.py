"""smollm-135m — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M; hf]

9 query heads are not divisible by the 16-way model axis; attention head
sharding is uneven (GSPMD pads) while FFN / vocab TP stays exact.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    pattern=(BlockSpec(mixer="attn"),),
    rope_theta=10_000.0,
    tie_embeddings=True,
    optimizer="adamw",
)
