"""Config system: architecture + shape configs and the registry.

A copy of the reference's ``repro/configs/base.py`` (pure dataclasses),
with imports rewritten; ``tests/test_torch_copies.py`` holds it to the
original. Each of the reference's architectures is a ``ModelConfig`` in
its own module under ``repro_torch.configs``; ``get_config(arch)`` resolves
by id. Each config carries a ``reduced()`` variant (same family, tiny
dims) used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------
# Layer plan: models are assembled as a sequence of stages; a stage is a
# repeated super-block of layer specs (scan-over-repeats with stacked params).
# This expresses dense stacks, 5:1 local:global patterns, cross-attn
# interleaves, hybrid Mamba+shared-attention, and dense->MoE transitions with
# one mechanism.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # attn | mla | mamba | cross_attn
    ffn: str = "dense"          # dense | moe | none
    window: int = 0             # 0 = full attention; >0 = sliding window
    shared: bool = False        # params shared across stage repeats


@dataclasses.dataclass(frozen=True)
class Stage:
    repeat: int
    layers: Tuple[LayerSpec, ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int             # informational total (per paper config listing)
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0
    local_global_ratio: int = 0     # N local layers per 1 global

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1

    # hybrid (zamba2): shared attention block applied every N ssm layers
    shared_attn_every: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0             # d_ff of the leading dense layers

    # VLM
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # audio
    num_codebooks: int = 0

    # MTP (deepseek-v3)
    mtp_depth: int = 0

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    opt_dtype: str = "float32"      # AdamW moment dtype (v3 uses bf16 to fit)
    notes: str = ""

    # ---- derived ---------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        # Production vocab padding (MaxText-style) so the vocab dim shards
        # cleanly over a 16-way model axis; logits beyond vocab_size masked.
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def plan(self) -> Tuple[Stage, ...]:
        """The stage/super-block decomposition of this architecture."""
        if self.family in ("dense", "audio"):
            return (Stage(self.num_layers, (LayerSpec("attn", "dense"),)),)
        if self.family == "ssm":
            return (Stage(self.num_layers, (LayerSpec("mamba", "none"),)),)
        if self.family == "hybrid":
            k = self.shared_attn_every
            blocks, rem = divmod(self.num_layers, k)
            stages = []
            if blocks:
                stages.append(Stage(blocks, tuple(
                    [LayerSpec("mamba", "none")] * k
                    + [LayerSpec("attn", "none", shared=True)])))
            if rem:
                stages.append(Stage(rem, (LayerSpec("mamba", "none"),)))
            return tuple(stages)
        if self.family == "vlm":
            k = self.cross_attn_every
            blocks, rem = divmod(self.num_layers, k)
            stages = []
            if blocks:
                stages.append(Stage(blocks, tuple(
                    [LayerSpec("attn", "dense")] * (k - 1)
                    + [LayerSpec("cross_attn", "dense")])))
            if rem:
                stages.append(Stage(rem, (LayerSpec("attn", "dense"),)))
            return tuple(stages)
        if self.family == "moe":
            kind = "mla" if self.use_mla else "attn"
            stages = []
            if self.first_dense_layers:
                stages.append(Stage(self.first_dense_layers,
                                    (LayerSpec(kind, "dense"),)))
            stages.append(Stage(self.num_layers - self.first_dense_layers,
                                (LayerSpec(kind, "moe"),)))
            return tuple(stages)
        if self.family == "local_global":
            r = self.local_global_ratio
            local = LayerSpec("attn", "dense", window=self.sliding_window)
            glob = LayerSpec("attn", "dense", window=0)
            blocks, rem = divmod(self.num_layers, r + 1)
            stages = []
            if blocks:
                stages.append(Stage(blocks, tuple([local] * r + [glob])))
            if rem:
                stages.append(Stage(rem, (local,)))
            return tuple(stages)
        raise ValueError(f"unknown family {self.family}")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / mostly-local)."""
        return self.family in ("ssm", "hybrid", "local_global")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d = self.d_model
        n = 0
        for stage in self.plan():
            per_block = 0
            for spec in stage.layers:
                if spec.kind == "attn" or spec.kind == "cross_attn":
                    qkv = d * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
                    o = self.num_heads * self.head_dim * d
                    per_layer = qkv + o
                    if spec.kind == "cross_attn":
                        per_layer += qkv  # separate kv proj for image tokens
                elif spec.kind == "mla":
                    per_layer = (
                        d * self.q_lora_rank
                        + self.q_lora_rank * self.num_heads
                        * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                        + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                        + self.kv_lora_rank * self.num_heads
                        * (self.qk_nope_head_dim + self.v_head_dim)
                        + self.num_heads * self.v_head_dim * d)
                elif spec.kind == "mamba":
                    d_in = self.ssm_d_inner
                    g = self.ssm_ngroups
                    per_layer = (
                        d * (2 * d_in + 2 * g * self.ssm_state + self.ssm_heads)
                        + d_in * d + 3 * self.ssm_heads + d_in)
                else:
                    per_layer = 0
                if spec.ffn == "dense":
                    ff = self.dense_d_ff or self.d_ff
                    per_layer += 3 * d * ff
                elif spec.ffn == "moe":
                    per_layer += d * self.num_experts
                    per_layer += 3 * d * self.moe_d_ff * self.num_experts
                    per_layer += 3 * d * self.moe_d_ff * self.num_shared_experts
                per_layer += 2 * d  # norms
                if spec.shared:
                    per_layer = per_layer / max(stage.repeat, 1)
                per_block += per_layer
            n += int(stage.repeat * per_block)
        n += self.padded_vocab_size * d * 2  # embed + unembed
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        moe_layers = self.num_layers - self.first_dense_layers
        inactive_experts = self.num_experts - self.experts_per_token
        inactive = moe_layers * 3 * self.d_model * self.moe_d_ff * inactive_experts
        return full - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, min(4, self.num_layers)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            q_lora_rank=32 if self.use_mla else 0,
            kv_lora_rank=32 if self.use_mla else 0,
            qk_nope_head_dim=16 if self.use_mla else 0,
            qk_rope_head_dim=8 if self.use_mla else 0,
            v_head_dim=16 if self.use_mla else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            sliding_window=8 if self.sliding_window else 0,
            local_global_ratio=min(self.local_global_ratio, 1),
            shared_attn_every=2 if self.shared_attn_every else 0,
            num_experts=8 if self.num_experts else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            first_dense_layers=1 if self.first_dense_layers else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            num_image_tokens=8 if self.num_image_tokens else 0,
            mtp_depth=self.mtp_depth,
        )
        return r


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per DESIGN.md §long_500k."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped: pure full-attention arch at 512k decode"
    return True, ""


def _load_all() -> None:
    # Importing the arch modules registers them: the reference's ten.
    from repro_torch.configs import deepseek_coder_33b  # noqa: F401
    from repro_torch.configs import deepseek_moe_16b  # noqa: F401
    from repro_torch.configs import deepseek_v3_671b  # noqa: F401
    from repro_torch.configs import gemma3_4b  # noqa: F401
    from repro_torch.configs import granite_3_8b  # noqa: F401
    from repro_torch.configs import llama_3_2_vision_90b  # noqa: F401
    from repro_torch.configs import mamba2_370m  # noqa: F401
    from repro_torch.configs import musicgen_medium  # noqa: F401
    from repro_torch.configs import qwen2_7b  # noqa: F401
    from repro_torch.configs import zamba2_2_7b  # noqa: F401
