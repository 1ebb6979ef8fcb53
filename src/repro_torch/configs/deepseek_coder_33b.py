"""DeepSeek-Coder 33B [arXiv:2401.14196; hf] — llama architecture.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, kv_heads=8, d_ff=19200,
    vocab=32_256, head_dim=128,
    pattern=(LayerKind.ATTN,),
    rope_theta=100_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, kv_heads=2,
                          head_dim=16, d_ff=160, vocab=256, remat="none")
