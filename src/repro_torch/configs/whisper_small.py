"""Whisper-small [arXiv:2212.04356; unverified].

12L encoder + 12L decoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
Conv frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed (B, 1500, 768) frame embeddings.  Adaptations recorded in
DESIGN.md: rotary decoder positions and SwiGLU FFN in place of Whisper's
learned positions / GELU (structure-preserving; parameter shapes match).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        num_layers=12, d_model=768, num_heads=12, kv_heads=12,
        d_ff=3072, vocab=51865, encoder_layers=12, encoder_ctx=1500,
        supports_long_context=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced", family="audio",
        num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=128, vocab=256, encoder_layers=2, encoder_ctx=32,
        remat=False,
    )
