"""falcon-mamba-7b [ssm]: attention-free Mamba1 [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024, ssm_kind="mamba1", ssm_state=16, ssm_conv=4,
    ssm_expand=2, sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512, ssm_kind="mamba1", ssm_state=8, ssm_conv=4,
    ssm_expand=2, remat="none", sub_quadratic=True,
)
