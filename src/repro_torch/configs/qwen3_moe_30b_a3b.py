"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936, MoE 128e top-8.
head_dim=128 explicit (Qwen3 projects 2048 -> 32*128) and qk-norm per Qwen3.
"""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, kv_heads=4, head_dim=128,
        d_ff=0, vocab=151936, qk_norm=True, rope_theta=1e6,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-reduced", family="moe",
        num_layers=4, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=0, vocab=256, qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96, group_size=64),
        remat=False,
    )
