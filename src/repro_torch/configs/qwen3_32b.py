"""Qwen3-32B [hf:Qwen/Qwen3-32B].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk-norm,
head_dim=128 explicit.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=64, kv_heads=8, head_dim=128,
        d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True, remat=False,
    )
