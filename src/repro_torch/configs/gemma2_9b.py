"""Gemma 2 9B [arXiv:2408.00118; hf].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.  Alternating
local (window 4096) / global attention, attention-logit softcap 50, final
logit softcap 30, GeGLU MLP, post-norms, embed scaling (gemma family).
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, kv_heads=8, d_ff=14336,
    vocab=256_000, head_dim=256,
    pattern=(LayerKind.ATTN, LayerKind.ATTN),   # local, global
    window=4096, local_mask=(True, False),
    attn_softcap=50.0, logit_softcap=30.0,
    mlp="geglu", post_norms=True, embed_scale=True,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256, window=16,
                          remat="none")
