"""Chameleon-34B [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536; early-fusion VLM —
VQ image tokens share the text vocabulary, so the modality frontend is a
STUB per the assignment (``input_specs`` supplies mixed token ids).
qk-norm per the Chameleon paper (their training-stability fix).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        num_layers=48, d_model=8192, num_heads=64, kv_heads=8, head_dim=128,
        d_ff=22016, vocab=65536, qk_norm=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced", family="vlm",
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True, remat=False,
    )
