"""mamba2-370m — 48L d_model=1024 attention-free, ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,       # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
