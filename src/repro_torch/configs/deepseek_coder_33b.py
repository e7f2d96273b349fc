"""DeepSeek-Coder-33B [arXiv:2401.14196].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 (llama architecture).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        num_layers=62, d_model=7168, num_heads=56, kv_heads=8, head_dim=128,
        d_ff=19200, vocab=32256, rope_theta=1e5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, remat=False,
    )
