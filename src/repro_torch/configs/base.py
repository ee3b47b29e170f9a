"""ModelConfig, input shapes, and the nested federated sub-configs composed
by ``repro_torch.fl.api.FLConfig``.

A copy of the JAX package's ``configs/base.py`` (pure dataclasses, no array
library), so both packages validate and default every field the same way.
The FL sub-configs (SelectionConfig, PersonalizationConfig, CodecConfig,
SchedulerConfig, ExecutionConfig, TrainConfig, FaultConfig) build their
runtime objects lazily (``strategy_obj``/``codec_obj``). Some of their
options are not ported yet: ``repro_torch.fl.sched.check_slice`` raises
``NotImplementedError`` for those, naming the ROADMAP.md item that ports
them, instead of ignoring them.
"""

from __future__ import annotations

import dataclasses


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0               # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0             # per-expert FFN width (fine-grained MoE)
    moe_every: int = 1               # MoE at layer indices where idx % moe_every == moe_offset
    moe_offset: int = 0
    first_dense: int = 0             # deepseek: leading dense layers

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla | none
    kv_lora_rank: int = 0            # MLA compressed KV dim
    qk_rope_dim: int = 64            # MLA decoupled-RoPE dim
    qk_nope_dim: int = 128           # MLA content dim per head
    v_head_dim: int = 128            # MLA value dim per head
    rope_variant: str = "full"       # full | half (chatglm 2d) | mrope
    mrope_sections: tuple = (16, 24, 24)  # qwen2-vl: t/h/w of head_dim//2
    sliding_window: int = 0          # >0: sliding-window attention (long_500k variant)

    # --- SSM (mamba-1) ---
    ssm: bool = False
    attn_period: int = 0             # hybrid: 1 attn layer per `attn_period` (jamba=8)
    attn_offset: int = 4             # position of the attn layer inside the period
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model/16)

    # --- encoder-decoder / modality frontends (STUBS per assignment) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper 30 s of 10 ms frames / 2 (conv stride)
    frontend: str = "none"           # none | audio_stub | vision_stub
    n_vision_tokens: int = 0         # qwen2-vl: patch embeds prepended
    max_decoder_seq: int = 0         # cap decoder seq (whisper 448)

    # --- misc ---
    eos_token_id: int = 1            # sequence terminator the serving loop
                                     # retires lanes on (tokenizer-defined;
                                     # 1 matches the seed's serve driver)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    capacity_factor: float = 1.25    # MoE token-dropping capacity
    source: str = ""                 # citation

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to x256 so the vocab dim shards over any mesh axis
        (whisper 51865 -> 51968, granite 49155 -> 49408)."""
        return round_up(self.vocab_size, 256)

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def is_moe_layer(self, idx: int) -> bool:
        if not self.moe or idx < self.first_dense:
            return False
        return (idx % self.moe_every) == self.moe_offset

    def is_attn_layer(self, idx: int) -> bool:
        """For hybrid archs: which layers are attention (vs SSM)."""
        if self.attn_type == "none":
            return False
        if not self.ssm:
            return True
        if self.attn_period <= 0:
            return False
        return (idx % self.attn_period) == self.attn_offset

    def param_count(self) -> int:
        """Analytic parameter count N (total, incl. all experts)."""
        d, v = self.d_model, self.vocab_padded
        total = v * d + (0 if self.tie_embeddings else v * d) + d
        hd = self.head_dim_
        for i in range(self.n_layers):
            total += 2 * d  # norms
            if self.ssm and not self.is_attn_layer(i):
                # mamba mixer (MoE/FFN may still follow — jamba interleaves both)
                di, ds_, dtr = self.d_inner, self.d_state, self.dt_rank_
                total += d * 2 * di + self.d_conv * di + di * (dtr + 2 * ds_)
                total += dtr * di + di * ds_ + di + di * d  # dt_proj, A, D, out
            elif self.attn_type == "mla":
                r = self.kv_lora_rank
                qd = self.qk_nope_dim + self.qk_rope_dim
                total += d * self.n_heads * qd          # W_q
                total += d * (r + self.qk_rope_dim)     # W_dkv + rope
                total += r * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                total += self.n_heads * self.v_head_dim * d  # W_o
            elif self.attn_type == "gqa":
                total += d * self.n_heads * hd          # W_q
                total += 2 * d * self.n_kv_heads * hd   # W_k, W_v
                total += self.n_heads * hd * d          # W_o
            if self.is_moe_layer(i):
                dff = self.d_ff_expert or self.d_ff
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * dff
                total += self.n_shared_experts * 3 * d * dff
            elif self.d_ff:
                total += 3 * d * self.d_ff  # SwiGLU
        if self.encoder_decoder:
            # encoder: self-attn + FFN per layer; decoder adds cross-attn
            enc = self.n_encoder_layers * (
                2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + 3 * d * self.d_ff + 2 * d
            )
            cross = self.n_layers * (
                2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + d
            )
            total += enc + cross + self.encoder_seq * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dff = self.d_ff_expert or self.d_ff
        inactive_per_moe_layer = (self.n_experts - self.top_k) * 3 * d * dff
        n_moe = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        return int(self.param_count() - n_moe * inactive_per_moe_layer)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers (one full hybrid period for jamba),
        d_model<=256, <=4 experts, small vocab."""
        n_layers = 2
        attn_period = self.attn_period
        if self.ssm and self.attn_period:
            n_layers = self.attn_period  # keep one full mamba+attn period
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, max(1, n_heads // 2)) if n_heads else 0,
            d_ff=min(self.d_ff, 512),
            d_ff_expert=min(self.d_ff_expert, 128) if self.d_ff_expert else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4) if self.moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.moe else 0,
            head_dim=min(self.head_dim_, 64) if self.n_heads else 0,
            mrope_sections=(8, 12, 12) if self.rope_variant == "mrope" else self.mrope_sections,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_rope_dim=16 if self.attn_type == "mla" else self.qk_rope_dim,
            qk_nope_dim=32 if self.attn_type == "mla" else self.qk_nope_dim,
            v_head_dim=32 if self.attn_type == "mla" else self.v_head_dim,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            n_vision_tokens=min(self.n_vision_tokens, 16) if self.n_vision_tokens else 0,
            first_dense=min(self.first_dense, 1),
            d_state=min(self.d_state, 8),
            dt_rank=8 if self.ssm else 0,
            max_decoder_seq=min(self.max_decoder_seq, 64) if self.max_decoder_seq else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    needs_subquadratic: bool = False  # long_500k


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1, needs_subquadratic=True),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


# ---------------------------------------------------------------------------
# federated sub-configs (composed by repro_torch.fl.api.FLConfig)
# ---------------------------------------------------------------------------

PERSONALIZATION_MODES = ("none", "ft", "pms", "dld")


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """Which clients train each round (paper §3.2-3.3 + baselines)."""

    strategy: str = "acsp-fl"   # see repro_torch.core.selection registry
    fraction: float = 0.5       # k/C for fraction-based strategies
    decay: float = 0.005        # phi decay (Eq. 6) for deev/acsp-fl; 0 disables

    def __post_init__(self):
        if self.decay < 0.0:
            raise ValueError(f"decay must be >= 0, got {self.decay!r}")

    def strategy_obj(self):
        from repro_torch.core.selection import get_strategy

        if self.strategy in ("deev", "acsp-fl"):
            return get_strategy(self.strategy, decay=self.decay)
        # fraction only matters for the remaining strategies, so it is
        # validated here rather than at construction (deev configs may carry
        # the default fraction untouched)
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"fraction must be in (0, 1] for strategy {self.strategy!r}, got {self.fraction!r}"
            )
        return get_strategy(self.strategy, fraction=self.fraction)


@dataclasses.dataclass(frozen=True)
class PersonalizationConfig:
    """How clients' local models relate to the global one (paper §3.4)."""

    mode: str = "dld"           # none | ft | pms | dld
    pms_layers: int = 2         # shared-prefix length when mode == 'pms'

    def __post_init__(self):
        if self.mode not in PERSONALIZATION_MODES:
            raise ValueError(
                f"unknown personalization mode {self.mode!r}; have {list(PERSONALIZATION_MODES)}"
            )
        if self.pms_layers < 1:
            raise ValueError(f"pms_layers must be >= 1, got {self.pms_layers!r}")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Uplink wire format (repro_torch.comm.make_codec spec)."""

    spec: str = "float32"       # float32 | int8 | int4 | topk | topk+int8 ...
    bits: int = 8               # bits for the generic 'quantize' atom
    topk_fraction: float = 0.1  # k/n for the 'topk' atom

    def __post_init__(self):
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction!r}"
            )

    def codec_obj(self):
        from repro_torch.comm import make_codec

        return make_codec(self.spec, bits=self.bits, topk_fraction=self.topk_fraction)


SCHEDULER_MODES = ("sync", "async")
STALENESS_FN_NAMES = ("constant", "polynomial", "hinge")

# Populations at or above this size default to the host-resident population
# plane (ExecutionConfig.host_population == 0 -> auto).
HOST_POPULATION_THRESHOLD = 50_000


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How much compute a round physically touches.

    ``cohort_size`` bounds the gathered client lanes K (0 -> K = C),
    ``eval_every`` thins the O(C) evaluation, ``scan_chunk`` fuses rounds on
    the device, ``cohort_devices`` shards the cohort over devices,
    ``host_population`` keeps the (C, ...) slabs on the host,
    ``eval_chunk`` streams evaluation, ``edge_groups`` adds edge-server
    aggregation. The port runs every one of them: chunks are CUDA-graph
    replays on the card, the host plane is ``repro_torch.fl.population``,
    and ``cohort_devices`` shards a barrier round's lanes over the ranks of
    a ``torch.distributed`` process group (``repro_torch.fl.shard``: -1
    takes the whole group, N a group of N ranks).
    """

    cohort_size: int = 0        # 0 -> full population (dense-equivalent)
    eval_every: int = 1         # evaluate when t % eval_every == 0
    scan_chunk: int = 1         # rounds fused per on-device scan chunk;
                                # 1 -> per-round host sync, 0 -> whole run
    cohort_devices: int = 0     # 0 -> unsharded; -1 -> every rank of the
                                # process group; N -> a group of N ranks
    host_population: int = 0    # 0 -> auto (>= HOST_POPULATION_THRESHOLD);
                                # 1 -> force host-resident; -1 -> never
    eval_chunk: int = 0         # host-population eval streaming: clients per
                                # device eval call; 0 -> whole population
    edge_groups: int = 0        # 0 -> flat aggregation; E >= 1 -> two-level
                                # edge-server aggregation over E id blocks

    def __post_init__(self):
        if self.cohort_size < 0:
            raise ValueError(f"cohort_size must be >= 0, got {self.cohort_size!r}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every!r}")
        if self.scan_chunk < 0:
            raise ValueError(f"scan_chunk must be >= 0, got {self.scan_chunk!r}")
        if self.cohort_devices < -1:
            raise ValueError(
                f"cohort_devices must be >= -1, got {self.cohort_devices!r}"
            )
        if self.host_population not in (-1, 0, 1):
            raise ValueError(
                f"host_population must be -1, 0, or 1, got {self.host_population!r}"
            )
        if self.eval_chunk < 0:
            raise ValueError(f"eval_chunk must be >= 0, got {self.eval_chunk!r}")
        if self.edge_groups < 0:
            raise ValueError(f"edge_groups must be >= 0, got {self.edge_groups!r}")
        if self.host_population == 1 and self.cohort_devices != 0:
            raise ValueError(
                "host_population=1 does not compose with cohort_devices: the "
                "host plane stages (K, ...) slabs per round outside the "
                "sharded executor"
            )

    def resolved_cohort(self, n_clients: int) -> int:
        """Static cohort lane count K for a population of ``n_clients``."""
        if self.cohort_size <= 0:
            return n_clients
        return min(self.cohort_size, n_clients)

    def resolved_host_population(self, n_clients: int) -> bool:
        """Whether a population of ``n_clients`` runs on the host plane."""
        if self.host_population == 1:
            return True
        if self.host_population == -1 or self.cohort_devices != 0:
            return False
        return n_clients >= HOST_POPULATION_THRESHOLD

    def resolved_chunk(self, rounds: int) -> int:
        """Rounds fused per on-device chunk for a ``rounds``-round run."""
        if self.scan_chunk <= 0:
            return rounds
        return min(self.scan_chunk, rounds)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """How the server loop executes rounds: ``sync`` is the paper's
    barrier loop, ``async`` FedBuff-style buffered execution over
    ``max_concurrency`` dispatch slots (``repro_torch.fl.sched``).
    """

    mode: str = "sync"            # sync | async
    buffer_k: int = 0             # async: updates per aggregation; 0 -> C//2
    max_concurrency: int = 0      # async: in-flight dispatch slots M_c
                                  # (FedBuff's concurrency cap); 0 -> C
    staleness_fn: str = "polynomial"   # constant | polynomial | hinge
    staleness_exponent: float = 0.5    # a in (1+s)^-a / hinge slope
    staleness_threshold: float = 4.0   # hinge knee b
    heterogeneity: float = 0.0    # lognormal sigma of per-client delay
                                  # multipliers; 0 = uniform client clocks

    def __post_init__(self):
        if self.mode not in SCHEDULER_MODES:
            raise ValueError(
                f"unknown scheduler mode {self.mode!r}; have {list(SCHEDULER_MODES)}"
            )
        if self.buffer_k < 0:
            raise ValueError(f"buffer_k must be >= 0, got {self.buffer_k!r}")
        if self.max_concurrency < 0:
            raise ValueError(
                f"max_concurrency must be >= 0, got {self.max_concurrency!r}"
            )
        if self.staleness_fn not in STALENESS_FN_NAMES:
            raise ValueError(
                f"unknown staleness_fn {self.staleness_fn!r}; have {list(STALENESS_FN_NAMES)}"
            )
        if self.staleness_exponent <= 0.0:
            raise ValueError(
                f"staleness_exponent must be > 0, got {self.staleness_exponent!r}"
            )
        if self.staleness_threshold < 0.0:
            raise ValueError(
                f"staleness_threshold must be >= 0, got {self.staleness_threshold!r}"
            )
        if self.heterogeneity < 0.0:
            raise ValueError(
                f"heterogeneity must be >= 0, got {self.heterogeneity!r}"
            )


CORRUPTION_KINDS = ("nan", "inf", "scale")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Failure semantics (``repro_torch.fl.faults``, the port of the JAX
    package's ``fl/faults.py``).

    All knobs default OFF. An enabled config runs under both schedulers:
    crashes, deadlines and slowdowns are resolved on the host from the
    seeded per-round plan, corrupted updates are rewritten on the device
    and rejected by the always-on finite-delta guard (capped by
    ``max_update_norm``), and the async scheduler retries failed dispatches
    with exponential backoff. Faults do not compose with ``edge_groups`` or
    ``cohort_devices`` (``ValueError``, as in the JAX package).
    """

    dropout_rate: float = 0.0   # P(crash before upload) per dispatch-round
    deadline_s: float = 0.0     # sync round deadline / async slot timeout;
                                # 0 -> no deadline
    corrupt_rate: float = 0.0   # P(update corrupted) per surviving dispatch
    max_retries: int = 2        # async: re-dispatches per slot before freeing
    slow_rate: float = 0.0      # P(transient slowdown) per dispatch-round
    slow_factor: float = 4.0    # duration multiplier for slowed dispatches
    corrupt_scale: float = 1e6  # multiplier for the 'scale' corruption kind
    backoff_s: float = 1.0      # async retry backoff base (doubles per retry)
    max_update_norm: float = 0.0  # guard ceiling on finite deltas; 0 -> off
    fault_seed: int = 0         # folded with cfg.seed into the fault stream

    def __post_init__(self):
        for field in ("dropout_rate", "corrupt_rate", "slow_rate"):
            v = getattr(self, field)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{field} must be in [0, 1), got {v!r}")
        for field in ("deadline_s", "backoff_s", "max_update_norm"):
            if getattr(self, field) < 0.0:
                raise ValueError(
                    f"{field} must be >= 0, got {getattr(self, field)!r}"
                )
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries!r}"
            )
        if self.slow_factor < 1.0:
            raise ValueError(
                f"slow_factor must be >= 1, got {self.slow_factor!r}"
            )

    @property
    def enabled(self) -> bool:
        """Whether any fault-injection path is active (the schedulers build
        their fault-aware step variants only when this is true)."""
        return (
            self.dropout_rate > 0.0
            or self.deadline_s > 0.0
            or self.corrupt_rate > 0.0
            or self.slow_rate > 0.0
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Server loop + local SGD hyperparameters (Algorithms 1 & 2)."""

    rounds: int = 100
    epochs: int = 1             # tau — local epochs
    batch_size: int = 32
    lr: float = 0.1
    momentum: float = 0.0
    seed: int = 0
    remainder: str = "drop"     # drop | pad — what SGDTrainer does with the
                                # tail when the data slab is not a whole
                                # number of batches ("drop" is the seed's
                                # remainder-truncation; "pad" trains on
                                # every valid sample via a masked tail batch)

    def __post_init__(self):
        for field in ("rounds", "epochs", "batch_size"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got {getattr(self, field)!r}")
        if self.lr <= 0.0:
            raise ValueError(f"lr must be > 0, got {self.lr!r}")
        if self.remainder not in ("drop", "pad"):
            raise ValueError(
                f"remainder must be 'drop' or 'pad', got {self.remainder!r}"
            )
