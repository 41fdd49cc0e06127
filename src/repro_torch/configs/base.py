"""Configuration schema: model, shapes and run knobs (port of
``repro.configs.base``).

Every architecture is a ``ModelConfig`` whose ``layer_pattern`` cycles block
kinds over the depth.  The port serves the dense attention family (kind
``attn``) so far; the other kinds are described here so that the registry
is the JAX package's, and raise in
:func:`repro_torch.models.blocks.block_apply`.

``RunConfig`` builds the port's :class:`repro_torch.core.telemetry.GCConfig`,
which has no kernel-dispatch knobs: the port dispatches on the device of
the tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.telemetry import GCConfig

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    layer_pattern: Tuple[str, ...] = ("attn",)
    # attention
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_softcap: float = 0.0       # gemma2 attention logit softcap
    final_softcap: float = 0.0      # gemma2 final logit softcap
    local_window: int = 0           # sliding window for "local" blocks
    post_norms: bool = False        # gemma2 sandwich norms
    # MLP
    act: str = "silu"               # silu | gelu | geglu
    gated_mlp: bool = True          # False: classic 2-matrix FFN
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "global"
    # recurrent (ssm / hybrid)
    conv_width: int = 4
    rnn_width: Optional[int] = None
    mlstm_chunk: int = 64
    proj_factor: float = 2.0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_tokens: int = 0
    # modality frontend stub (vlm / audio)
    frontend: str = "none"          # none | vit_patches | audio_frames
    frontend_tokens: int = 0
    # embeddings
    tie_embeddings: bool = True
    embed_scale: bool = False       # gemma-style sqrt(d) embedding scaling
    # norm
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def tail_layers(self) -> int:
        return self.num_layers % len(self.layer_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's formula)."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * hd * n_q + 2 * d * hd * n_kv + n_q * hd * d
        if self.qkv_bias:
            attn += hd * (n_q + 2 * n_kv)
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        moe = 0
        if self.num_experts:
            moe = (self.num_experts + self.num_shared_experts) * 3 * d * self.d_ff
            moe += d * self.num_experts  # router
            mlp = 0
        rnn_w = self.rnn_width or d
        kind_params = {
            "attn": attn + mlp + moe,
            "local": attn + mlp + moe,
            "mlstm": int(2.5 * d * int(d * self.proj_factor))
            + 4 * (int(d * self.proj_factor)) * hd,
            "slstm": 4 * d * d + 4 * d * hd + d * 2 * d + mlp * 0,
            "rglru": 2 * d * rnn_w + 2 * rnn_w + rnn_w * self.conv_width
            + rnn_w * d + mlp,
        }
        total = 0
        for i in range(self.num_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            total += kind_params[kind]
            total += 2 * d  # norms
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * d)
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class RunConfig:
    """Serve-time knobs.  ``gc`` holds every GC knob; when it is not passed,
    ``__post_init__`` assembles it from the flat fields, and when it is, the
    flat fields are set from it, so the two views never disagree."""
    model: ModelConfig
    shape: ShapeConfig
    gc: Optional[GCConfig] = None
    gc_policy: str = "slrt"
    versions_per_slot: int = 8
    reader_lanes: int = 16
    # retire-ring capacity for the RT policies; 0 = sized from the batch
    ring_capacity: int = 0

    def __post_init__(self):
        if self.gc is None:
            object.__setattr__(self, "gc", GCConfig(
                policy=self.gc_policy,
                versions_per_slot=self.versions_per_slot,
                reader_lanes=self.reader_lanes,
                ring_capacity=self.ring_capacity))
        else:
            object.__setattr__(self, "gc_policy", self.gc.policy)
            object.__setattr__(self, "versions_per_slot",
                               self.gc.versions_per_slot)
            object.__setattr__(self, "reader_lanes", self.gc.reader_lanes)
            object.__setattr__(self, "ring_capacity", self.gc.ring_capacity)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(1, cfg.num_heads)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        num_experts=min(cfg.num_experts, 4),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_tokens=min(cfg.encoder_tokens, 16) if cfg.encoder_tokens else 0,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens else 0,
        rnn_width=64 if cfg.rnn_width else None,
        mlstm_chunk=8,
    )
    # keep the layer pattern but shrink repeats
    base["num_layers"] = max(len(cfg.layer_pattern), 2)
    if len(cfg.layer_pattern) == 1:
        base["num_layers"] = 2
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
