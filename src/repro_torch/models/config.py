"""Architecture configuration dataclass shared by all assigned archs.

A copy of ``repro.models.config`` (which needs no JAX): the port keeps its
own, so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # normalization / attention details
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0          # partial rotary (GLM4 uses 0.5)
    attn_bias: bool = False
    mlp_act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    pos_embedding: str = "rope"         # rope | learned
    sliding_window: Optional[int] = None  # always-on local attention width

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_routing: str = "dense"          # dense | scatter

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    conv_width: int = 4

    # hybrid (recurrentgemma / Griffin)
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # modality frontend stub (audio frames / vision patches)
    frontend: Optional[str] = None       # None | "audio" | "vision"
    frontend_len: int = 0                # number of stub embedding positions

    # numerics
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 256
    # remat: "full" recomputes everything in backward; "dots" saves matmul
    # outputs (keeps TP collectives out of the recompute path)
    remat_policy: str = "full"
    # pin attention activation layouts (q heads->model, kv replicated):
    # removes GSPMD resharding churn when kv_heads < model-axis size
    attn_act_shard: bool = False
    # Megatron-style sequence parallelism: residual stream sharded over
    # "model" on the sequence dim between layers (AR -> AG+RS)
    seq_parallel: bool = False
    # decode KV cache dtype: param dtype, or "int8" (per-token-per-head
    # absmax quantization; halves the memory-bound decode cache traffic)
    kv_cache_dtype: str = "auto"

    # long-context fallback for full-attention archs (DESIGN.md §4)
    long_context_window: int = 4096

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    def n_params(self) -> int:
        """Approximate parameter count (used for 6ND model-flops)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        V = self.padded_vocab
        total = V * d * (1 if self.tie_embeddings else 2)
        if self.pos_embedding == "learned":
            total += 8192 * d
        att = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d

        def mlp_params():
            return d * f * (3 if self.mlp_act == "swiglu" else 2)

        per_layer = 0
        if self.arch_type in ("dense", "vlm", "audio"):
            per_layer = att + mlp_params()
        elif self.arch_type == "moe":
            per_layer = att + self.num_experts * 3 * d * f + d * self.num_experts
        elif self.arch_type == "ssm":
            di, ns, nh = self.ssm_dinner, self.ssm_state, self.ssm_nheads
            zdim = 2 * di + 2 * self.ssm_groups * ns + nh
            per_layer = d * zdim + di * d + 2 * nh
        elif self.arch_type == "hybrid":
            w = self.lru_width
            rec = 2 * d * w + w * d + 4 * w   # approx RG-LRU block
            attn_l = att + mlp_params()
            pat = self.block_pattern or ("rec",)
            frac_attn = pat.count("attn") / len(pat)
            per_layer = frac_attn * (attn_l) + (1 - frac_attn) * (rec + mlp_params())
        total += int(L * per_layer)
        if self.is_encoder_decoder:
            enc = self.num_encoder_layers * (att + mlp_params())
            cross = self.num_layers * att
            total += int(enc + cross)
        return int(total)

    def active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.arch_type != "moe":
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        att = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
        per_layer = att + self.num_experts_per_tok * 3 * d * f + d * self.num_experts
        return int(self.padded_vocab * d * 2 + L * per_layer)
