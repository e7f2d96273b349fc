"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (MHA, kv=32) d_ff=5632 vocab=100352.
Adaptation noted in DESIGN.md: full rotary instead of partial (25 %).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        num_layers=24, d_model=2048, num_heads=32, kv_heads=32,
        d_ff=5632, vocab=100352,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=128, vocab=256, remat=False,
    )
