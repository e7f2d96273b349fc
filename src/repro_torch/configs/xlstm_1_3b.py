"""xLSTM-1.3B [arXiv:2405.04517; unverified].

48 blocks, d_model=2048, 4 heads, vocab=50304, d_ff=0 (xLSTM blocks carry
their own projections: mLSTM up-projects 2x, sLSTM has a 4/3 FFN).
Alternating mLSTM/sLSTM pattern.  Recurrent state -> runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, kv_heads=4, head_dim=512,
        d_ff=0, vocab=50304,
        block_pattern=("mlstm", "slstm"),
        xlstm=XLSTMConfig(),
        supports_long_context=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-reduced", family="ssm",
        num_layers=4, d_model=64, num_heads=2, kv_heads=2, head_dim=32,
        d_ff=0, vocab=256,
        block_pattern=("mlstm", "slstm"),
        xlstm=XLSTMConfig(),
        supports_long_context=True, remat=False,
    )
