"""zamba2-2.7b — 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Mamba2 backbone + ONE shared attention+MLP block applied every
6 layers (9 applications, each with its own KV cache). [arXiv:2411.15242]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    hybrid_attn_every=6,
    tie_embeddings=True,
)
