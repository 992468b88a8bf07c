"""zamba2-2.7b [hybrid]: Mamba2 backbone with a weight-shared attention
block applied every 6th layer [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, mlp_type="gelu",
    ssm_kind="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, hybrid_every=6, sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=512, mlp_type="gelu",
    ssm_kind="mamba2", ssm_state=16, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=16, hybrid_every=6, remat="none", sub_quadratic=True,
)
