"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, mlp_type="squared_relu",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, mlp_type="squared_relu", remat="none",
)
