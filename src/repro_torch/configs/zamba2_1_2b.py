"""Zamba2-1.2B [arXiv:2411.15242; hf].

38 layers, d_model=2048, Mamba2 backbone (ssm_state=64, 64 SSM heads of
64) with a **weight-shared** attention block (32 heads MHA + GELU MLP
d_ff=8192) invoked twice per superblock of 19.  The reference's
configuration, field for field, less ``long_context``: only the
``long_500k`` applicability check reads it, and that is not ported.
"""
from repro_torch.configs import ModelConfig, register

register(
    ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        superblock=("mamba2",) * 9 + ("shared",) + ("mamba2",) * 9,
        activation="gelu",
        ssm_state=64,
        ssm_heads=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,
        notes="shared attention block: one weight set, 2 invocations "
              "(distinct KV caches). Decode cost is O(1) per token for the "
              "36 mamba2 layers; the 2 shared-attn calls keep a KV cache "
              "(full attention), dominated by the mamba backbone at 500k.",
    )
)
