"""Model configuration dataclasses shared by every architecture.

The port's own copy of ``repro.models.config`` (the port imports nothing of
``repro``); the fields, defaults and ``param_counts`` are the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert_ff: int = 0      # 0 -> no shared expert
    every_n_layers: int = 1        # MoE FFN every n-th layer (1 = all)
    group_size: int = 512          # dispatch group size (tokens)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    m_proj_factor: float = 2.0     # mLSTM up-projection
    s_ff_factor: float = 1.3334    # sLSTM feed-forward
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``block_pattern`` x ``repeat`` defines the stack.

    ``block_pattern`` entries: 'attn' | 'attn_local' | 'mamba' | 'mlstm' |
    'slstm'.  The stack scans over ``repeat`` copies of the pattern
    (homogeneous superblocks -> compact HLO).  FFN kind per layer is derived
    from ``moe.every_n_layers`` (dense FFN otherwise, none if d_ff == 0).
    """
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    block_pattern: tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    rope: bool = True              # False -> NoPE (Jamba)
    rope_theta: float = 10000.0
    window: int = 0                # sliding-window size for 'attn_local'
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    encoder_layers: int = 0        # >0 -> encoder-decoder (whisper)
    encoder_ctx: int = 1500        # stub frontend frames
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    opt_memory_mode: str = "fp32"  # "bf16": no fp32 master, bf16 moments
    remat_policy: str = "nothing"  # "nothing" | "dots" (save matmul outputs)
    # which shape cells are runnable (see DESIGN.md §4)
    supports_long_context: bool = False
    decode_supported: bool = True
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not a multiple of "
                f"pattern {len(self.block_pattern)}")

    @property
    def repeat(self) -> int:
        return self.num_layers // len(self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (drives roofline MODEL_FLOPS = 6*N*D) ----
    def param_counts(self) -> dict[str, float]:
        d, hd = self.d_model, self.head_dim
        q_dim, kv_dim = self.num_heads * hd, self.kv_heads * hd
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        mamba = 0.0
        if self.mamba is not None:
            di = self.mamba.expand * d
            dtr = self.mamba.dt_rank or -(-d // 16)
            mamba = (d * 2 * di + di * self.mamba.d_conv
                     + di * (dtr + 2 * self.mamba.d_state) + dtr * di
                     + di * self.mamba.d_state + di + di * d)
        mlstm = slstm = 0.0
        if self.xlstm is not None:
            di = int(self.xlstm.m_proj_factor * d)
            mlstm = d * 2 * di + di * self.xlstm.conv_kernel + 3 * di * di // 4 \
                + di * d  # qkv heads projections approximated at hd blocks
            dff = int(self.xlstm.s_ff_factor * d)
            slstm = 4 * d * d + 2 * d * dff
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0

        n_att = sum(p.startswith("attn") for p in self.block_pattern) * self.repeat
        n_mam = sum(p == "mamba" for p in self.block_pattern) * self.repeat
        n_ml = sum(p == "mlstm" for p in self.block_pattern) * self.repeat
        n_sl = sum(p == "slstm" for p in self.block_pattern) * self.repeat

        total_attn = n_att * attn + n_mam * mamba + n_ml * mlstm + n_sl * slstm
        active_ffn = total_ffn = 0.0
        if self.moe is not None:
            n_moe = self.num_layers // self.moe.every_n_layers
            n_dense = self.num_layers - n_moe
            e_ffn = 3 * d * self.moe.d_ff_expert
            shared = 3 * d * self.moe.shared_expert_ff if self.moe.shared_expert_ff else 0
            total_ffn = (n_moe * (self.moe.num_experts * e_ffn + shared)
                         + n_dense * dense_ffn)
            active_ffn = (n_moe * (self.moe.top_k * e_ffn + shared)
                          + n_dense * dense_ffn)
        else:
            total_ffn = active_ffn = self.num_layers * dense_ffn

        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn + dense_ffn) if self.encoder_layers else 0
        # decoder cross-attention adds one attn-sized block per layer
        cross = self.num_layers * attn if self.encoder_layers else 0
        total = total_attn + total_ffn + embed + enc + cross
        active = total_attn + active_ffn + embed + enc + cross
        return {"total": total, "active": active}
