"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style 64-expert top-6
fine-grained MoE [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=163840, mlp_type="swiglu",
    num_experts=64, num_shared_experts=0, top_k=6, d_ff_expert=1408,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512, mlp_type="swiglu",
    num_experts=8, num_shared_experts=0, top_k=2, d_ff_expert=32,
    moe_group=64, remat="none",
)
