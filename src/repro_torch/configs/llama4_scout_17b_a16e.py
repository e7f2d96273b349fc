"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 with a
shared expert (Llama-4 MoE = 1 shared + 16 routed, top-1), early fusion.
"""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, kv_heads=8, head_dim=128,
        d_ff=0, vocab=202048, rope_theta=5e5,
        moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                      shared_expert_ff=8192),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=0, vocab=256,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=96,
                      shared_expert_ff=96, group_size=64),
        remat=False,
    )
