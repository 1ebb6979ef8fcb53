"""Qwen1.5 110B [hf:Qwen/Qwen1.5-110B; family verified at 0.5B scale].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.  QKV bias
(the Qwen1.5 signature).
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    n_layers=80, d_model=8192, n_heads=64, kv_heads=8, d_ff=49152,
    vocab=152_064, head_dim=128,
    pattern=(LayerKind.ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, kv_heads=2,
                          head_dim=8, d_ff=256, vocab=256, remat="none")
