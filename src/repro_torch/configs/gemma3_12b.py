"""Gemma-3-12B [hf:google/gemma-3-12b-pt; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144; 5:1 local:global
sliding-window pattern (window 1024), head_dim=256 explicit, tied embeddings,
128k context.  Runs the long_500k cell: 5/6 of layers hold only a
1024-entry ring KV.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, kv_heads=8, head_dim=256,
        d_ff=15360, vocab=262144, window=1024, rope_theta=1e6,
        tie_embeddings=True, qk_norm=True,
        block_pattern=("attn_local", "attn_local", "attn_local",
                       "attn_local", "attn_local", "attn"),
        supports_long_context=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-reduced", family="dense",
        num_layers=6, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=16, tie_embeddings=True, qk_norm=True,
        block_pattern=("attn_local", "attn_local", "attn_local",
                       "attn_local", "attn_local", "attn"),
        supports_long_context=True, remat=False,
    )
