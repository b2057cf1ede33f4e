"""``FLConfig``, ``ModelConfig``, ``TrainConfig`` and ``MeshConfig`` — the
port's copies of the same records in ``repro.config``: the same fields,
defaults and validation, so one configuration means the same run in both
packages. ``MeshConfig``'s ``model`` axis keeps its field, but the port's
mesh (``launch/mesh.py``) takes only ``model=1``: the client axes over
ranks, no tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class FLConfig:
    """FedP2P / FedAvg protocol parameters (paper §3.1, Algo 1 & 2)."""

    num_clients: int = 100           # N
    num_clusters: int = 10           # L (FedP2P local P2P networks)
    devices_per_cluster: int = 10    # Q
    participation: int = 10          # P for FedAvg (=|Z|); FedP2P uses L*Q
    rounds: int = 100                # T
    local_epochs: int = 20           # E (paper §4.2)
    batch_size: int = 10             # O
    lr: float = 0.01                 # eta
    straggler_rate: float = 0.0      # fraction of selected devices that drop
    sync_period: int = 1             # global sync every k rounds (1 = paper)
    seed: int = 0
    # any registered protocol name; validated at dispatch — unknown names
    # raise
    algorithm: str = "fedp2p"
    # §5: upgrade the algorithm to its "_topo" hop-aware variant
    topology_aware: bool = False
    # the lossy wire format of exchanged updates (a repro_torch.compression
    # name: none | bf16 | int8 | topk)
    codec: str = "none"
    # which mixing lowering the engines run (dense | sparse | auto):
    # "dense" = the [D, D] mixing-matrix form (the fed_mix kernel),
    # "sparse" = the protocol's structured MixingSpec (the fed_mix_segment
    # kernel; raises for spec-less protocols), "auto" = sparse exactly
    # where a spec exists.
    mix_path: str = "auto"
    # --- sampled participation (protocols.engine.SampledEngine) ---
    num_enrolled: int = 0
    participants_per_round: int = 0
    participation_strategy: str = "uniform"
    participation_rate: float = 1.0
    # --- fault tolerance / store (protocols.store) ---
    store_read_retries: int = 2
    store_read_backoff: float = 0.05
    prefetch_timeout: float = 0.0

    def __post_init__(self):
        if self.num_enrolled < 0:
            raise ValueError(
                f"FLConfig: num_enrolled must be >= 0 (0 = resident mode), "
                f"got {self.num_enrolled}")
        if self.participants_per_round < 0:
            raise ValueError(
                f"FLConfig: participants_per_round must be >= 0 (0 = the "
                f"protocol's own participant count), got "
                f"{self.participants_per_round}")
        if (self.num_enrolled and self.participants_per_round
                and self.participants_per_round > self.num_enrolled):
            raise ValueError(
                f"FLConfig: participants_per_round="
                f"{self.participants_per_round} active clients exceed the "
                f"num_enrolled={self.num_enrolled} enrolled population; a "
                "sampled round needs K <= D")
        if not (0.0 < self.participation_rate <= 1.0):
            raise ValueError(
                f"FLConfig: participation_rate must lie in (0, 1], got "
                f"{self.participation_rate}")
        if self.store_read_retries < 0:
            raise ValueError(
                f"FLConfig: store_read_retries must be >= 0, got "
                f"{self.store_read_retries}")
        if self.store_read_backoff < 0:
            raise ValueError(
                f"FLConfig: store_read_backoff must be >= 0, got "
                f"{self.store_read_backoff}")
        if self.prefetch_timeout < 0:
            raise ValueError(
                f"FLConfig: prefetch_timeout must be >= 0 (0 = wait "
                f"forever), got {self.prefetch_timeout}")

    @property
    def enrolled(self) -> int:
        """D — the client population a state store holds: ``num_enrolled``
        when sampled participation is on, else ``num_clients``."""
        return self.num_enrolled or self.num_clients


@dataclass(frozen=True)
class MeshConfig:
    """The mesh's axis sizes: ``pod`` x ``data`` client axes (one client a
    rank) and the ``model`` axis."""
    data: int = 16
    model: int = 16
    pod: int = 1                     # >1 => multi-pod

    @property
    def num_devices(self) -> int:
        return self.pod * self.data * self.model

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod", "data", "model") if self.pod > 1
                else ("data", "model"))

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((self.pod, self.data, self.model) if self.pod > 1
                else (self.data, self.model))


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for one model.

    Covers: dense decoder transformers (GQA/MQA, bias variants, GeGLU /
    SwiGLU / squared-ReLU MLPs), MoE (top-k routed + shared experts, MLA),
    SSM (Mamba-2 SSD), hybrid (parallel attention+SSM heads), audio and VLM
    decoder backbones.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    num_heads: int = 0               # query heads; 0 => attention-free (pure SSM)
    num_kv_heads: int = 0            # KV heads for GQA/MQA; ==num_heads => MHA
    head_dim: int = 0                # 0 => d_model // num_heads
    qkv_bias: bool = False           # qwen2-style bias on q/k/v projections
    qk_norm: bool = False            # chameleon-style RMSNorm on q and k
    rope_theta: float = 10000.0
    rope_pct: float = 1.0            # nemotron uses partial rotary (0.5)
    sliding_window: int = 0          # 0 => full attention; >0 => window size
    global_layer_every: int = 0      # hybrid: every k-th layer is full-attn

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ---
    d_ff: int = 0
    mlp_variant: str = "swiglu"      # swiglu | geglu | squared_relu | gelu
    mlp_bias: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden size (0 => d_ff)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    first_dense_layers: int = 0      # deepseek: first k layers are dense
    moe_dense_d_ff: int = 0          # hidden size of those dense layers

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba) ---
    num_meta_tokens: int = 0

    # --- embeddings / misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"       # rmsnorm | rmsnorm_p1 (gemma +1) | layernorm
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    logit_softcap: float = 0.0
    # audio (musicgen): number of parallel codebooks + cross-attention context
    num_codebooks: int = 0
    cross_attend: bool = False
    cross_context_len: int = 0
    cross_context_dim: int = 0
    # vlm (chameleon): fraction of sequence that is VQ image tokens (stub frontend)
    image_token_frac: float = 0.0

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads and not self.num_kv_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    # --- derived sizes -------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.num_heads == 0

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    def reduced(self, *, num_layers: int = 2, max_d_model: int = 256,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (per the brief:
        <=2 layers, d_model<=512, <=4 experts)."""
        d = min(self.d_model, max_d_model)
        scale = d / self.d_model
        heads = max(1, min(self.num_heads, 4)) if self.num_heads else 0
        kv = 0
        if heads:
            kv = max(1, min(self.num_kv_heads, heads))
            while heads % kv:
                kv -= 1
        changes = dict(
            num_layers=num_layers,
            d_model=d,
            vocab_size=min(self.vocab_size, vocab),
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(d // heads if heads else 0),
            d_ff=max(8, int(self.d_ff * scale)) if self.d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
        )
        if self.num_experts:
            ne = min(self.num_experts, max_experts)
            changes.update(
                num_experts=ne,
                num_experts_per_tok=min(self.num_experts_per_tok, ne),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=max(8, int((self.moe_d_ff or self.d_ff) * scale)),
                moe_dense_d_ff=max(8, int((self.moe_dense_d_ff or self.d_ff or 64) * scale)),
            )
        if self.use_mla:
            changes.update(kv_lora_rank=32, q_lora_rank=0,
                           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                           head_dim=24)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.num_meta_tokens:
            changes.update(num_meta_tokens=8)
        if self.cross_attend:
            changes.update(cross_context_len=8, cross_context_dim=d)
        if self.sliding_window:
            changes.update(sliding_window=64)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class TrainConfig:
    """LM training driver settings (``launch/train.py``)."""

    optimizer: str = "adamw"         # sgd | momentum | adamw
    lr: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    momentum: float = 0.9
    schedule: str = "cosine"         # constant | cosine | warmup_cosine
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    remat: bool = True
    microbatches: int = 1        # gradient-accumulation steps per batch
    seed: int = 0
