"""InternVL2-1B — InternViT-300M frontend (STUB) + InternLM2-Chat-1.8B-ish
0.9B text backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The ViT frontend
is a stub per the assignment: ``input_specs`` provides precomputed patch
embeddings (B, 256, d_model) prepended to the token embeddings.
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24, d_model=896, n_heads=14, kv_heads=2, d_ff=4864,
    vocab=151_655, head_dim=64,
    pattern=(LayerKind.ATTN,),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend_len=256,          # ViT patch embeddings (stub)
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256,
                          frontend_len=8, remat="none")
