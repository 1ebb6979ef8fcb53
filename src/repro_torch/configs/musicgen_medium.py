"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec
tokens.

48L d_model=1536 24H (MHA: kv=24) d_ff=6144 vocab=2048.  The EnCodec
frontend is a stub: ``input_specs`` provides precomputed frame embeddings
(the codebook-interleaving delay pattern collapses to a single token
stream at the backbone boundary).  GELU MLP (the MusicGen transformer).
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, kv_heads=24, d_ff=6144,
    vocab=2_048, head_dim=64,
    pattern=(LayerKind.ATTN,),
    mlp="gelu",
    tie_embeddings=True,
    frontend_len=128,          # conditioning frames (stub)
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=4,
                          head_dim=16, d_ff=128, vocab=128,
                          frontend_len=8, remat="none")
