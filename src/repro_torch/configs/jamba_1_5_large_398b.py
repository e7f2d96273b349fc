"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave (attention at position 3 of each 8-layer
period), MoE every second layer, no positional embeddings (NoPE).
"""

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536, rope=False,
        block_pattern=("mamba", "mamba", "mamba", "attn",
                       "mamba", "mamba", "mamba", "mamba"),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                      every_n_layers=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        supports_long_context=True,
        # 398B fp32 Adam state cannot fit a single 256-chip v5e pod; bf16
        # moments + no fp32 master (6 B/param) keep the train cell resident.
        opt_memory_mode="bf16",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, rope=False,
        block_pattern=("mamba", "mamba", "mamba", "attn",
                       "mamba", "mamba", "mamba", "mamba"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96,
                      every_n_layers=2, group_size=64),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        supports_long_context=True, remat=False,
    )
