"""Mixtral 8x22B [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768; MoE with 8
experts, top-2 routing; sliding-window attention (assignment spec).
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, kv_heads=8, d_ff=16384,
    vocab=32_768, head_dim=128,
    pattern=(LayerKind.MOE,),
    window=4096, local_mask=(True,),       # SWA on every layer
    n_experts=8, top_k=2, capacity_factor=1.25,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, kv_heads=2,
                          head_dim=8, d_ff=128, vocab=256, window=16,
                          n_experts=4, top_k=2, moe_seq_chunk=0,
                          remat="none")
