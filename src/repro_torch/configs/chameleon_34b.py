"""chameleon-34b [vlm]: early-fusion, VQ image tokens share the text
vocabulary [arXiv:2405.09818]. The modality frontend is a STUB per the
assignment: ``input_specs`` provides token ids only (VQ-encoded image
patches arrive as ordinary vocabulary ids in the unified 65536 vocab)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, mlp_type="swiglu", rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, mlp_type="swiglu", remat="none",
)
