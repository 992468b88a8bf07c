"""llama3.2-1b [dense]: small llama3, GQA + SwiGLU [hf:meta-llama]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256, mlp_type="swiglu", rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, mlp_type="swiglu", remat="none",
)
