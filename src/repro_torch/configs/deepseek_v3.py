"""DeepSeek-V3 [arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3 config.json].

61L d_model=7168 128H; latent attention (MLA: q_lora 1536, kv_lora 512,
nope 128 + rope 64 per query head, v 128) with YaRN rope (factor 40 over
4096 positions); the first 3 layers dense (d_ff 18432), the other 58
MoE: 256 routed experts of width 2048, top-8, sigmoid routing with a
bias, 8 groups of which 4 are kept, gates renormalised × 2.5, one
shared expert.  Vocabulary 129280, untied.

A card holds 8 of each MoE layer's 256 routed experts, experts 0–7:
chip 0's share of the published expert-parallel layout over 32 chips
(EP32), which every deployment of this model divides its experts by;
the router keeps its 256 outputs.  The port's own arch, not the JAX
package's: it resolves through :func:`repro_torch.configs.get_config`
and is not in ``ARCH_IDS``.
"""

from ..models.config import LayerKind, MLAConfig

CONFIG = MLAConfig(
    name="deepseek-v3",
    n_layers=61, d_model=7168, n_heads=128, kv_heads=128, d_ff=18432,
    vocab=129_280, head_dim=128,
    pattern=(LayerKind.MOE,), first_k_dense_replace=3,
    n_experts=256, top_k=8, n_shared_experts=1, moe_intermediate_size=2048,
    n_group=8, topk_group=4,
    routed_scaling_factor=2.5, experts_held=8, expert_first=0,
    kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    rope_theta=10_000.0, yarn_factor=40.0,
    yarn_original_max_position_embeddings=4096, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_mscale=1.0, yarn_mscale_all_dim=1.0,
    norm_eps=1e-6, tie_embeddings=False,
)


def smoke_config() -> MLAConfig:
    """One dense and two MoE layers at small widths: 16 experts in 4
    groups (2 kept), top-4, 8 of them held (experts 4–11), so that
    tokens route to experts held elsewhere too."""
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, kv_heads=4,
                          head_dim=8, d_ff=96, vocab=256,
                          first_k_dense_replace=1, n_experts=16, top_k=4,
                          moe_intermediate_size=32, n_group=4, topk_group=2,
                          experts_held=8, expert_first=4, kv_lora_rank=16,
                          q_lora_rank=24, qk_nope_head_dim=8,
                          qk_rope_head_dim=4, v_head_dim=8,
                          moe_seq_chunk=0, remat="none")
