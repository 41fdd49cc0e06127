"""Architecture registry (port of ``repro.configs``): the ten configs of the
JAX package with their published widths, and their reduced smoke variants.

A copy, not an import: importing ``repro`` imports JAX.  The port serves
all ten: dense (minitron-4b, qwen2.5-32b, starcoder2-7b), local ring
caches (gemma2-2b), mixtures of experts (granite-moe-1b-a400m,
deepseek-moe-16b), the recurrent families (recurrentgemma-9b,
xlstm-125m), the VLM prefix (internvl2-2b) and the encoder-decoder
(whisper-tiny).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, RunConfig, SHAPES,
                                      ShapeConfig, reduced)

XLSTM_125M = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    rope=False, proj_factor=2.0, mlstm_chunk=64, tie_embeddings=True,
)  # [arXiv:2405.04517]

GRANITE_MOE_1B = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=32, top_k=8,
)  # [hf:ibm-granite/granite-3.0-1b-a400m-base]

DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    num_experts=64, num_shared_experts=2, top_k=6,
)  # [arXiv:2401.06066]

INTERNVL2_2B = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    frontend="vit_patches", frontend_tokens=256,
)  # [arXiv:2404.16821]

MINITRON_4B = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000,
)  # [arXiv:2407.14679] pruned nemotron

QWEN25_32B = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True,
)  # [hf:Qwen/Qwen2.5]

STARCODER2_7B = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    act="gelu", gated_mlp=False,
)  # [arXiv:2402.19173]

GEMMA2_2B = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    layer_pattern=("local", "attn"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    act="geglu", embed_scale=True,
)  # [arXiv:2408.00118]

WHISPER_TINY = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_tokens=1500,
    frontend="audio_frames", frontend_tokens=1500,
    rope=True,
    act="gelu", gated_mlp=False,
)  # [arXiv:2212.04356]

RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    layer_pattern=("rglru", "rglru", "local"), local_window=2048,
    rnn_width=4096, conv_width=4, act="geglu", embed_scale=True,
)  # [arXiv:2402.19427]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        XLSTM_125M, GRANITE_MOE_1B, DEEPSEEK_MOE_16B, INTERNVL2_2B,
        MINITRON_4B, QWEN25_32B, STARCODER2_7B, GEMMA2_2B, WHISPER_TINY,
        RECURRENTGEMMA_9B,
    ]
}

# long_500k needs sub-quadratic handling of the 524288-token context:
# SSM (O(1) state), hybrid (bounded local windows + RG-LRU), gemma2 (local
# half bounded by window; global half linear per decoded token).  Pure
# full-attention archs and whisper (architecturally bounded decoder) skip it.
LONG_CONTEXT_ARCHS = {"xlstm-125m", "recurrentgemma-9b", "gemma2-2b"}

__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "ModelConfig", "RunConfig",
           "SHAPES", "ShapeConfig", "get_config", "list_archs", "reduced",
           "reduced_config", "runnable"]


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def list_archs() -> List[str]:
    return list(ARCHS)


def runnable(arch: str, shape: str) -> bool:
    """Whether the (arch, shape) cell runs: long_500k only for
    :data:`LONG_CONTEXT_ARCHS`."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def reduced_config(name: str, **overrides) -> ModelConfig:
    return reduced(ARCHS[name], **overrides)
