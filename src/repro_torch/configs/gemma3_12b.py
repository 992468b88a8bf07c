"""gemma3-12b [dense]: 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt]. head_dim is decoupled from d_model/num_heads
(256), as in the released gemma3 checkpoints."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144, mlp_type="gelu",
    attn_pattern="local_global", window_size=1024, global_every=6,
    rope_theta=1000000.0,
    sub_quadratic=True,  # 5-in-6 layers are sliding-window
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, mlp_type="gelu",
    attn_pattern="local_global", window_size=16, global_every=6, remat="none",
    sub_quadratic=True,
)
