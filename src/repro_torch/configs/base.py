"""Config dataclasses and the registry of the architectures the port runs.

A copy of ``repro.configs.base`` (the port imports nothing of the
reference, not even its JAX-free modules): the same ``ModelConfig`` fields
and defaults, ``reduced()`` and the shape cells, so that a config compares
equal field by field with the reference's.  The registry holds every
architecture of the reference's ``ALL_ARCHS`` (``configs/archs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | encdec | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads

    # attention
    attn_type: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"  # rope | learned

    # MLA (deepseek-v2 / minicpm3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0  # 0 → head_dim

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # hybrid (zamba2)
    shared_attn_period: int = 0  # apply shared attn block every N layers

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # stub frame embeddings
    frontend: Optional[str] = None  # audio | vision (stubbed)

    # -- optimization toggles of the reference --------------------------
    chunked_attention: bool = False  # flash-style online-softmax attention
    attn_chunk: int = 1024
    use_sp: bool = False  # sequence-parallel residual stream (seq over "model")
    grad_reduce_dtype: str = "float32"  # bf16 halves DP gradient collectives

    # numerics / misc
    activation: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long-context support marker (sub-quadratic token mixing)
    subquadratic: bool = False

    @property
    def padded_vocab(self):
        """Vocab padded to a multiple of 256 (Megatron-style) so the
        embedding/LM-head shard cleanly over any reasonable TP degree.
        Labels stay < vocab_size; pad logits train toward −∞ like any
        never-observed token."""
        mult = 256 if self.vocab_size >= 256 else 16
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def resolved_head_dim(self):
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_v_head_dim(self):
        return self.v_head_dim or self.resolved_head_dim

    @property
    def ssm_d_inner(self):
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self):
        return self.ssm_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            # hybrids need ≥ 2 shared-attn groups + a tail to exercise
            # their structure; everything else shrinks to 2 layers
            num_layers=7 if self.shared_attn_period else min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            q_lora_rank=48 if self.q_lora_rank else 0,
            rope_head_dim=16 if self.attn_type == "mla" else self.rope_head_dim,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 128,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=16 if self.encoder_layers else 1500,
            shared_attn_period=3 if self.shared_attn_period else 0,
            dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict = {}

class NotPortedError(NotImplementedError):
    """A part of the reference the port does not run yet (every
    architecture and family is ported; the name stays for callers that
    catch it)."""


def register(cfg: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registration side effects)

    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown architecture {name!r}; the port runs {sorted(_REGISTRY)}")


def list_configs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def runnable_shapes(cfg: ModelConfig):
    """The shape cells this architecture runs (long_500k only for
    sub-quadratic token mixers), as the reference's."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
