"""musicgen-large [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284]. Frontend STUB: 4 parallel codebook id streams
(the delay-pattern interleaving happens upstream); embeddings are summed
across codebooks and 4 untied heads emit per-codebook logits."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, mlp_type="gelu", num_codebooks=4,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=128, mlp_type="gelu", num_codebooks=4, remat="none",
)
