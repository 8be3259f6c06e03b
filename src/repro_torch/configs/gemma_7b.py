"""Gemma-7B [arXiv:2403.08295; hf].

28 layers, d_model=3072, 16 heads with head_dim=256 (q-dim 4096 > d_model,
faithful to the paper), MHA (kv=16; MQA is the 2b variant), GeGLU d_ff=24576,
vocab 256000, tied embeddings.
"""
from repro_torch.configs import ModelConfig, register

register(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        superblock=("attn",),
        activation="geglu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        notes="pure full attention -> long_500k skipped",
    )
)
