"""Llama 3.2 1B [hf:meta-llama/Llama-3.2-1B; unverified].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    n_layers=16, d_model=2048, n_heads=32, kv_heads=8, d_ff=8192,
    vocab=128_256, head_dim=64,
    pattern=(LayerKind.ATTN,),
    rope_theta=500_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, kv_heads=2,
                          head_dim=8, d_ff=256, vocab=256, remat="none")
