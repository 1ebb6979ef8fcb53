"""RecurrentGemma 2B (Griffin) [arXiv:2402.19427; hf].

26L d_model=2560 10H (local attn kv=1, MQA) d_ff=7680 vocab=256000.
Pattern: (RG-LRU, RG-LRU, local-attention) — 8 full units + 2 remainder
recurrent layers.  Local attention window 2048.  Sub-quadratic decode
(recurrent state + bounded window) ⇒ long_500k runs.
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256,
    pattern=(LayerKind.RGLRU, LayerKind.RGLRU, LayerKind.ATTN),
    window=2048, local_mask=(False, False, True),
    rnn_width=2560, conv_width=4,
    mlp="geglu", embed_scale=True,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=8, d_model=64, n_heads=4, kv_heads=1,
                          head_dim=16, d_ff=128, vocab=256, window=16,
                          rnn_width=64, remat="none")
