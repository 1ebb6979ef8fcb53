"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf] — attention-free.

32L d_model=4096 d_ff=14336 vocab=65536.  Data-dependent decay WKV with
64-dim heads (64 heads), token-shift ddlerp mixing.  O(1) decode state
⇒ long_500k runs.
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32, d_model=4096, n_heads=64, kv_heads=0, d_ff=14336,
    vocab=65_536, head_dim=64,
    pattern=(LayerKind.RWKV,),
    mlp="gelu",                # unused by rwkv blocks (squared-relu CM)
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=2, kv_heads=0,
                          head_dim=64, d_ff=256, vocab=256, remat="none")
