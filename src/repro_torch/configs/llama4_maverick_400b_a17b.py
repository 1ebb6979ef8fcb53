"""Llama 4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout family;
unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 per expert; MoE 128 experts
top-1 + 1 shared expert, interleaved dense/MoE layers (1:1).  Early
fusion is N/A here — the text backbone is modeled and any modality
frontend would arrive via ``input_specs`` embeddings like the other
stub frontends (DESIGN.md §4).
"""

from ..models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, kv_heads=8, d_ff=8192,
    vocab=202_048, head_dim=128,
    pattern=(LayerKind.ATTN, LayerKind.MOE),   # interleaved 1:1
    n_experts=128, top_k=1, n_shared_experts=1,
    capacity_factor=1.25,
    rope_theta=500_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=8, kv_heads=2,
                          head_dim=8, d_ff=128, vocab=256,
                          n_experts=8, top_k=1, n_shared_experts=1,
                          moe_seq_chunk=0, remat="none")
