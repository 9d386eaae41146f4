"""Model configuration for the PyTorch port.

A copy of `megatron_tpu.config.ModelConfig`, its derivations and the model
presets, with dtypes mapped to torch. The JAX package stays the reference;
the port keeps its own copy so that it never imports it.

`ParallelConfig`, `OptimizerConfig`, `TrainingConfig`, `DataConfig` and
`ResilienceConfig` are copied in full, `ServingConfig` (the serving
engine's) with every field and the checks on those the engine runs.
`MegatronConfig.to_json` and `from_dict` write and read the `model`,
`parallel`, `optimizer`, `training`, `data` and `resilience` sections of a
checkpoint's `config.json` under the reference's names; its serving
section is ignored here. `num_microbatches` is global_batch_size /
(micro_batch_size * dp).

The port runs the whole (dp, pp, cp, tp) mesh: the decoder LM with
sequence and context parallelism (ring or Ulysses attention), experts
sharded over tp or dp (`expert_axis`), the BERT, T5 and ICT steps over
(dp, tp), the ZeRO-1 optimizer, and pipeline parallelism (1F1B,
interleaved 1F1B and gpipe) for the LM, BERT and T5 steps (parallel/,
training/train_step.py). `MegatronConfig.validate` checks the pipeline
fields as the reference does.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def as_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    """Transformer architecture config (megatron_tpu/config.py ModelConfig);
    the fields and their defaults are the reference's."""

    num_layers: int = 2
    hidden_size: int = 128
    ffn_hidden_size: Optional[int] = None  # derived: 4h, or 8/3 h for GLU
    num_attention_heads: int = 4
    num_kv_heads: Optional[int] = None  # GQA/MQA; None -> MHA
    kv_channels: Optional[int] = None  # head dim; derived h / n_heads
    seq_length: int = 512
    max_position_embeddings: Optional[int] = None
    vocab_size: int = 32000
    make_vocab_size_divisible_by: int = 128

    use_rotary_emb: bool = True
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    use_position_embedding: bool = False

    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_epsilon: float = 1e-5
    # swiglu | geglu | reglu | liglu | gelu | relu | squared_relu
    activation: str = "swiglu"
    use_bias: bool = False
    use_post_ln: bool = False
    parallel_attn: bool = False
    parallel_layernorm: bool = False
    tie_embed_logits: bool = False

    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    lima_dropout: bool = False
    drop_path_rate: float = 0.0

    params_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    softmax_compute_fp32: bool = True
    apply_query_key_layer_scaling: bool = False
    attention_softmax_in_fp32: bool = True
    init_method_std: float = 0.02
    use_scaled_init: bool = True

    attention_impl: str = "dot"  # "flash" | "dot" | "ring" | "ulysses"
    sliding_window: Optional[int] = None
    recompute_granularity: str = "none"
    quantized_gemm: str = "none"  # "none" | "int8"

    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coeff: float = 1e-2
    moe_dispatch: str = "sort"

    @property
    def is_glu(self) -> bool:
        return self.activation in ("swiglu", "geglu", "reglu", "liglu")

    def derived(self) -> "ModelConfig":
        """Fill derived fields (ffn size, kv heads, head dim, max positions)."""
        if self.attention_impl not in ("dot", "flash", "ring", "ulysses"):
            raise ValueError(
                f"attention_impl must be 'dot', 'flash', 'ring' or "
                f"'ulysses', got {self.attention_impl!r}")
        if self.quantized_gemm not in ("none", "int8"):
            raise ValueError(f"quantized_gemm must be 'none' or 'int8', "
                             f"got {self.quantized_gemm!r}")
        d: dict[str, Any] = {}
        if self.num_kv_heads is None:
            d["num_kv_heads"] = self.num_attention_heads
        elif self.num_attention_heads % self.num_kv_heads:
            raise ValueError(
                f"num_attention_heads={self.num_attention_heads} must be a "
                f"multiple of num_kv_heads={self.num_kv_heads} (GQA groups)")
        if self.kv_channels is None:
            if self.hidden_size % self.num_attention_heads:
                raise ValueError("hidden_size must be a multiple of "
                                 "num_attention_heads")
            d["kv_channels"] = self.hidden_size // self.num_attention_heads
        if self.ffn_hidden_size is None:
            if self.is_glu:
                # llama convention: 2/3 * 4h rounded to multiple of 256
                ffn = int(8 * self.hidden_size / 3)
                d["ffn_hidden_size"] = 256 * ((ffn + 255) // 256)
            else:
                d["ffn_hidden_size"] = 4 * self.hidden_size
        if self.max_position_embeddings is None:
            d["max_position_embeddings"] = self.seq_length
        return dataclasses.replace(self, **d)

    @property
    def padded_vocab_size(self) -> int:
        m = self.make_vocab_size_divisible_by
        return m * ((self.vocab_size + m - 1) // m)


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (megatron_tpu/config.py ParallelConfig): the
    fields and defaults are the reference's. The mesh is (dp, pp, cp, tp)
    with tp fastest (parallel/mesh.py); `sequence_parallel` shards the
    residual stream's sequence dim over tp outside attention and the MLP,
    `context_parallel` shards it over cp everywhere (ring or Ulysses
    attention), `expert_axis` names the axis an expert bank's experts are
    cut over, and `use_distributed_optimizer` shards the fp32 moments over
    dp (ZeRO-1)."""

    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    data_parallel: Optional[int] = None  # derived from world size
    context_parallel: int = 1
    expert_parallel: int = 1  # unused; kept for config compatibility
    expert_axis: str = "tp"
    sequence_parallel: bool = False
    virtual_pipeline_chunks: int = 1
    pipeline_schedule: str = "1f1b"
    pipeline_store_activations: bool = False
    use_distributed_optimizer: bool = False

    def derive_dp(self, n_devices: int) -> int:
        denom = (self.tensor_parallel * self.pipeline_parallel *
                 self.context_parallel)
        if n_devices % denom:
            raise ValueError(f"world size {n_devices} not divisible by "
                             f"tp*pp*cp={denom}")
        return n_devices // denom


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam/SGD, the lr/wd schedule, clipping and loss scaling
    (megatron_tpu/config.py OptimizerConfig, all fields)."""

    optimizer: str = "adam"
    lr: float = 3e-4
    min_lr: float = 0.0
    lr_decay_style: str = "cosine"  # constant|linear|cosine|inverse-square-root
    lr_decay_iters: Optional[int] = None
    lr_warmup_iters: int = 0
    lr_warmup_fraction: Optional[float] = None
    weight_decay: float = 0.01
    start_weight_decay: Optional[float] = None
    end_weight_decay: Optional[float] = None
    weight_decay_incr_style: str = "constant"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    clip_grad: float = 1.0
    # loss scaling (needed only for fp16; bf16 trains unscaled)
    loss_scale: Optional[float] = None  # None -> dynamic if fp16
    initial_loss_scale: float = 2.0 ** 32
    min_loss_scale: float = 1.0
    loss_scale_window: int = 1000
    hysteresis: int = 2
    log_num_zeros_in_grad: bool = False
    override_opt_param_scheduler: bool = False
    use_checkpoint_opt_param_scheduler: bool = False


@dataclass(frozen=True)
class TrainingConfig:
    """Training-loop config (megatron_tpu/config.py TrainingConfig): every
    field keeps the reference's name and default. `sync_metrics` fetches
    the step's metrics every iteration instead of once per log window;
    `profile` records a torch.profiler trace over
    [profile_step_start, profile_step_end]."""

    micro_batch_size: int = 1
    global_batch_size: Optional[int] = None
    rampup_batch_size: Optional[tuple[int, int, int]] = None  # (start, incr, samples)
    train_iters: int = 100
    eval_interval: int = 1000
    eval_iters: int = 10
    log_interval: int = 10
    save_interval: Optional[int] = None
    exit_interval: Optional[int] = None
    exit_duration_in_mins: Optional[float] = None
    seed: int = 1234
    checkpoint_dir: Optional[str] = None
    load_dir: Optional[str] = None
    finetune: bool = False  # load weights only, reset iteration/optimizer
    no_load_optim: bool = False
    no_load_rng: bool = False
    wandb_logger: bool = False
    tensorboard_dir: Optional[str] = None
    sync_metrics: bool = False
    profile: bool = False
    profile_step_start: int = 10
    profile_step_end: int = 12
    profile_dir: Optional[str] = None
    no_save_optim: bool = False
    no_save_rng: bool = False
    log_params_norm: bool = False
    log_timers_to_tensorboard: bool = False
    log_validation_ppl_to_tensorboard: bool = False
    wandb_project: Optional[str] = None
    wandb_entity: Optional[str] = None
    wandb_id: Optional[str] = None
    wandb_resume: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config (megatron_tpu/config.py DataConfig), every
    field with the reference's name and default. `data_path` is [prefix]
    or [weight, prefix, ...]."""

    data_path: Optional[Sequence[Any]] = None
    split: str = "969,30,1"
    tokenizer_type: str = "SentencePieceTokenizer"
    vocab_file: Optional[str] = None
    merge_file: Optional[str] = None
    tokenizer_model: Optional[str] = None
    dataloader_type: str = "single"  # single | cyclic
    num_workers: int = 2
    reset_position_ids: bool = False
    reset_attention_mask: bool = False
    eod_mask_loss: bool = False
    vocab_extra_ids: int = 0
    vocab_extra_ids_list: Optional[str] = None
    masked_lm_prob: float = 0.15
    short_seq_prob: float = 0.1
    max_seq_length_dec: int = 128
    train_data_path: Optional[Sequence[Any]] = None
    valid_data_path: Optional[Sequence[Any]] = None
    test_data_path: Optional[Sequence[Any]] = None
    new_tokens: bool = True
    data_impl: str = "mmap"
    mmap_warmup: bool = False
    strict_data: bool = False


@dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs (megatron_tpu/config.py ResilienceConfig).

    SHA-256 manifests on save, verified on load with a fall-back to the
    newest valid checkpoint (`checkpoint_integrity`); retention of the
    newest `keep_last_k`; retried checkpoint I/O with jittered exponential
    backoff; the divergence guard (`max_consecutive_nonfinite`,
    `loss_spike_factor` over `loss_spike_window`, `max_rollbacks`); the
    hung-step watchdog (`step_timeout_s`, exiting with
    `watchdog_exit_code`)."""

    checkpoint_integrity: bool = True
    keep_last_k: Optional[int] = None
    io_retries: int = 4
    io_backoff_s: float = 0.5
    io_backoff_max_s: float = 30.0
    io_jitter: float = 0.25
    max_consecutive_nonfinite: int = 3
    loss_spike_factor: Optional[float] = None
    loss_spike_window: int = 32
    max_rollbacks: int = 2
    step_timeout_s: Optional[float] = None
    watchdog_exit_code: int = 43

    def validate(self) -> "ResilienceConfig":
        if self.step_timeout_s is not None and self.step_timeout_s <= 0.0:
            raise ValueError(f"step_timeout_s={self.step_timeout_s} must be "
                             "> 0 (None disables the watchdog)")
        if self.io_retries < 1 or self.io_backoff_s < 0.0 \
                or self.io_backoff_max_s < self.io_backoff_s \
                or not 0.0 <= self.io_jitter <= 1.0:
            raise ValueError("io_retries >= 1, 0 <= io_backoff_s <= "
                             "io_backoff_max_s and io_jitter in [0, 1]")
        if self.keep_last_k is not None and self.keep_last_k < 1:
            raise ValueError(f"keep_last_k={self.keep_last_k} must be >= 1 "
                             "(None keeps all)")
        if self.max_consecutive_nonfinite < 0 or self.max_rollbacks < 0 \
                or self.loss_spike_window < 1:
            raise ValueError("max_consecutive_nonfinite and max_rollbacks "
                             "must be >= 0, loss_spike_window >= 1")
        if self.loss_spike_factor is not None and \
                self.loss_spike_factor <= 1.0:
            raise ValueError(f"loss_spike_factor={self.loss_spike_factor} "
                             "must exceed 1.0")
        return self


SERVING_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                     "int8": torch.int8}

# ServingConfig fields the continuous-batching engine does not run yet,
# each with the later slice that brings it (ROADMAP Queue 1 item 7)
_LATER_SERVING = {
    "serving_tp": "the serving topology (Queue 1 item 7 (d))",
    "disaggregate_prefill": "the serving topology (Queue 1 item 7 (d))",
    "prefill_tp": "the serving topology (Queue 1 item 7 (d))",
    "decode_tp": "the serving topology (Queue 1 item 7 (d))",
    "serving_pp": "the serving topology (Queue 1 item 7 (d))",
    "pp_waves": "the serving topology (Queue 1 item 7 (d))",
    "placement_auto": "the serving topology (Queue 1 item 7 (d))",
    "placement_budget": "the serving topology (Queue 1 item 7 (d))",
}


@dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching engine config (megatron_tpu/config.py
    ServingConfig): every field keeps the reference's name and default.

    The engine runs `num_slots`, `max_queue`, `max_len`, `kv_dtype`
    (bfloat16, float32 or int8), `prefill_bucket` (rolling pools prefill
    at the exact length instead), `serial_fallback`,
    `request_deadline_s`, `decode_sync_interval`, `prefill_max_batch`,
    `kv_block_size` (a block arena: with `block_native_attn` read through
    the map by the Hopper kernel, without it bracketed by a gather into
    the contiguous view and a scatter back), `priority_levels`,
    `shed_on_overload` (early shedding of a request whose estimated queue
    delay already exceeds its deadline), `max_engine_restarts` (the
    supervisor's restart budget before the circuit breaker opens),
    `engine_step_timeout_s` (the hung-iteration watchdog) and the
    throughput features: `enable_prefix_cache` with `retained_slots`,
    `prefill_chunk`, `preemption` (with `priority_levels` >= 2) and
    `speculative_k`; and the front door: `num_replicas` engines behind the
    prefix-affinity router (`router_max_retries`,
    `router_heartbeat_timeout_s`), the SSE stream registry's
    `stream_ttl_s` and the host KV tier's byte budget `host_kv_bytes`
    (with the prefix cache on a block pool); LoRA serving: `adapter_slots`
    adapters of rank `adapter_rank` in a device bank (within
    `adapter_max_bank_bytes`) with `adapter_host_bytes` of checksummed
    host overflow; live weights: `swap_timeout_s` (the hot swap's
    drain budget) and the checkpoint watcher (`watch_checkpoints`, polled
    every `watch_interval_s`); and the brownout ladder (`degrade_ladder`
    rungs at `degrade_raise_at` pressures, `degrade_hysteresis`,
    `degrade_dwell_up`/`_down`, rung 2's `degrade_max_new_tokens`) with
    the SLO accounting (`slo_ttft_ms`, `slo_itl_p99_ms`); and remote
    replicas (serving/remote.py): `replica_mode` serves the wire surface
    a front tier drives (`prompt_tokens`, `/affinity`, `/invariants`),
    `fleet` ("host:port,...") makes the server a front tier over such
    processes that holds no weights, and `remote_connect_timeout_s`,
    `remote_read_timeout_s`, `remote_max_retries` and
    `remote_digest_interval_s` tune its client. `validate()` raises
    NotImplementedError for any other field set away from its default:
    the serving topology (ROADMAP Queue 1 item 7)."""

    num_slots: int = 8
    max_queue: int = 64
    max_len: Optional[int] = None
    kv_dtype: Optional[str] = None
    prefill_bucket: int = 16
    serial_fallback: bool = False
    request_deadline_s: Optional[float] = None
    decode_sync_interval: int = 1
    prefill_max_batch: int = 8
    enable_prefix_cache: bool = False
    prefill_chunk: Optional[int] = None
    retained_slots: Optional[int] = None
    kv_block_size: Optional[int] = None
    block_native_attn: bool = False
    speculative_k: int = 0
    priority_levels: int = 1
    shed_on_overload: bool = False
    degrade_ladder: int = 0
    degrade_raise_at: Optional[tuple] = None
    degrade_hysteresis: float = 0.5
    degrade_dwell_up: int = 2
    degrade_dwell_down: int = 4
    degrade_max_new_tokens: int = 64
    slo_ttft_ms: Optional[float] = None
    slo_itl_p99_ms: Optional[float] = None
    preemption: bool = False
    max_engine_restarts: int = 2
    engine_step_timeout_s: Optional[float] = None
    num_replicas: int = 1
    router_max_retries: int = 2
    router_heartbeat_timeout_s: float = 5.0
    host_kv_bytes: int = 0
    stream_ttl_s: float = 600.0
    serving_tp: int = 1
    disaggregate_prefill: bool = False
    prefill_tp: Optional[int] = None
    decode_tp: Optional[int] = None
    serving_pp: int = 1
    pp_waves: int = 1
    placement_auto: bool = False
    placement_budget: Optional[int] = None
    adapter_slots: int = 0
    adapter_rank: int = 8
    adapter_host_bytes: int = 0
    adapter_max_bank_bytes: Optional[int] = None
    swap_timeout_s: float = 120.0
    watch_checkpoints: Optional[str] = None
    watch_interval_s: float = 5.0
    replica_mode: bool = False
    fleet: Optional[str] = None
    remote_connect_timeout_s: float = 2.0
    remote_read_timeout_s: float = 30.0
    remote_max_retries: int = 2
    remote_digest_interval_s: float = 2.0

    def validate(self, model: Optional[ModelConfig] = None
                 ) -> "ServingConfig":
        """The reference's checks on the fields the engine runs, and a
        NotImplementedError for each field of a later slice that is set."""
        if model is not None and model.sliding_window is not None:
            # the reference's rolling exclusions: a rolling pool's ring
            # writes evict history, so an offset > 0 multi-token chunk or
            # a rejected verify draft cannot be undone, and whole-region
            # rolling rows cannot retain or park (their idle writes wrap
            # into the live ring)
            max_len = self.max_len or model.max_position_embeddings
            rolling = (model.attention_impl == "flash"
                       and model.sliding_window < max_len)
            blocks = self.kv_block_size is not None
            for bad, what in (
                    (self.enable_prefix_cache and not blocks,
                     "enable_prefix_cache without kv_block_size"),
                    (self.preemption and not blocks,
                     "preemption without kv_block_size"),
                    (self.prefill_chunk is not None, "prefill_chunk"),
                    (self.speculative_k, "speculative_k")):
                if rolling and bad:
                    raise ValueError(
                        f"{what} is unsupported on a rolling "
                        "(sliding-window) KV pool: its ring writes evict "
                        "history that a chunk, a rejected draft or an "
                        "idle retained row would need")
        defaults = ServingConfig()
        for name, slice_name in _LATER_SERVING.items():
            if getattr(self, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f"ServingConfig.{name}={getattr(self, name)!r}: "
                    f"{slice_name} is ported in a later slice")
        # the brownout ladder (serving/degrade.py): its shape fails here,
        # at config time, not mid-storm
        if not 0 <= self.degrade_ladder <= 4:
            raise ValueError(f"degrade_ladder={self.degrade_ladder} must be "
                             "in 0..4 (0 disables; 4 is the full brownout "
                             "ladder)")
        if self.degrade_raise_at is not None:
            if not self.degrade_ladder:
                raise ValueError(
                    "degrade_raise_at without degrade_ladder is inert: set "
                    "degrade_ladder >= 1 or drop the thresholds")
            ra = tuple(self.degrade_raise_at)
            if len(ra) != self.degrade_ladder:
                raise ValueError(
                    f"degrade_raise_at needs one threshold per level: "
                    f"degrade_ladder={self.degrade_ladder} but got "
                    f"{len(ra)} thresholds")
            if not (all(x > 0 for x in ra)
                    and all(b > a for a, b in zip(ra, ra[1:]))):
                raise ValueError(
                    f"degrade_raise_at must be positive and strictly "
                    f"increasing (a monotone ladder), got {ra}")
        if self.degrade_ladder:
            if not 0.0 < self.degrade_hysteresis < 1.0:
                raise ValueError(
                    f"degrade_hysteresis={self.degrade_hysteresis} must be "
                    "a ratio in (0, 1): the lower edge of each rung is "
                    "hysteresis * its raise edge")
            if self.degrade_dwell_up < 1 or self.degrade_dwell_down < 1:
                raise ValueError("degrade dwell counts must be >= 1 "
                                 "supervisor-loop evaluations")
            if self.degrade_max_new_tokens < 1:
                raise ValueError(
                    f"degrade_max_new_tokens={self.degrade_max_new_tokens} "
                    "must be >= 1: level 2 clamps new admissions' "
                    "max_new_tokens to it")
        for name in ("slo_ttft_ms", "slo_itl_p99_ms"):
            v = getattr(self, name)
            if v is not None and not v > 0.0:
                raise ValueError(f"{name} must be > 0 (None: no SLO), got "
                                 f"{v}")
        # live weights (serving/weights.py)
        if self.swap_timeout_s <= 0.0:
            raise ValueError(f"swap_timeout_s must be > 0, got "
                             f"{self.swap_timeout_s}")
        if self.watch_interval_s <= 0.0:
            raise ValueError(f"watch_interval_s must be > 0, got "
                             f"{self.watch_interval_s}")
        if self.watch_checkpoints and self.serial_fallback:
            raise ValueError(
                "watch_checkpoints requires the continuous-batching engine: "
                "the serial fallback path has no engine to hot-swap")
        # multi-tenant LoRA serving (serving/adapters.py)
        if self.adapter_slots < 0 or self.adapter_host_bytes < 0:
            raise ValueError("adapter_slots and adapter_host_bytes must be "
                             ">= 0")
        if self.adapter_slots:
            if self.adapter_rank < 1:
                raise ValueError(
                    f"adapter_slots={self.adapter_slots} requires "
                    f"adapter_rank >= 1 (got {self.adapter_rank}): a rank-0 "
                    "bank holds no delta")
            if self.serial_fallback:
                raise ValueError(
                    "adapter_slots > 0 requires the continuous-batching "
                    "engine: the serial fallback path threads no adapter "
                    "bank")
            if model is not None and model.quantized_gemm != "none":
                # the int8 quantizer is not linear: quantize(W) x + A B x
                # is not quantize(W + A B) x, so factored serving would
                # drift from any merged reference
                raise ValueError(
                    "adapter_slots > 0 is unsupported with "
                    "quantized_gemm='int8': the low-rank delta rides outside "
                    "the quantized projection. int8 KV pools remain "
                    "available")
            if self.adapter_max_bank_bytes is not None and model is not None:
                from megatron_tpu_torch.serving.adapters import \
                    adapter_bank_nbytes
                need = adapter_bank_nbytes(model, self.adapter_slots,
                                           self.adapter_rank)
                if need > self.adapter_max_bank_bytes:
                    raise ValueError(
                        f"adapter bank of {self.adapter_slots} slots at rank "
                        f"{self.adapter_rank} needs {need} device bytes, "
                        f"exceeding adapter_max_bank_bytes="
                        f"{self.adapter_max_bank_bytes}")
        elif self.adapter_host_bytes:
            raise ValueError("adapter_host_bytes > 0 without adapter_slots: "
                             "there is no bank to overflow")
        if self.kv_dtype is not None and self.kv_dtype not in \
                SERVING_KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of "
                             f"{sorted(SERVING_KV_DTYPES)}, got "
                             f"{self.kv_dtype!r}")
        for name in ("num_slots", "max_queue", "prefill_bucket",
                     "decode_sync_interval", "prefill_max_batch",
                     "priority_levels"):
            if getattr(self, name) < 1:
                raise ValueError(f"ServingConfig.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 (None: "
                             f"unchunked), got {self.prefill_chunk}")
        if self.retained_slots is not None and self.retained_slots < 0:
            raise ValueError(f"retained_slots must be >= 0 (None: no "
                             f"limit), got {self.retained_slots}")
        if self.enable_prefix_cache and self.kv_block_size is not None \
                and self.kv_block_size % self.prefill_bucket:
            # a hit is block-aligned for aliasing and bucket-aligned so
            # the suffix shapes are the unchunked engine's
            raise ValueError(
                f"kv_block_size={self.kv_block_size} must be a multiple of "
                f"prefill_bucket={self.prefill_bucket} with "
                "enable_prefix_cache")
        if self.preemption and self.priority_levels < 2:
            raise ValueError(
                "preemption requires priority_levels >= 2: with one "
                "priority class no arrival can outrank a running slot")
        if self.speculative_k < 0:
            raise ValueError(f"speculative_k must be >= 0, got "
                             f"{self.speculative_k}")
        if self.speculative_k:
            max_len = self.max_len or (model.max_position_embeddings
                                       if model is not None else None)
            if max_len is not None and self.speculative_k >= max_len:
                raise ValueError(
                    f"speculative_k={self.speculative_k} must be smaller "
                    f"than the slot capacity (max_len={max_len})")
        if self.max_engine_restarts < 0:
            raise ValueError("max_engine_restarts must be >= 0")
        if self.num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got "
                             f"{self.num_replicas}")
        if self.router_max_retries < 0:
            raise ValueError(f"router_max_retries must be >= 0, got "
                             f"{self.router_max_retries}")
        if self.router_heartbeat_timeout_s <= 0.0:
            raise ValueError("router_heartbeat_timeout_s must be > 0")
        if self.stream_ttl_s <= 0.0:
            raise ValueError("stream_ttl_s must be > 0")
        if self.host_kv_bytes < 0:
            raise ValueError(f"host_kv_bytes must be >= 0, got "
                             f"{self.host_kv_bytes}")
        if self.host_kv_bytes and not (self.enable_prefix_cache
                                       and self.kv_block_size is not None):
            # the tier demotes and restores retained block lists
            raise ValueError(
                "host_kv_bytes requires enable_prefix_cache and "
                "kv_block_size: the host tier demotes retained prefix "
                "block lists")
        if self.num_replicas > 1 and self.serial_fallback:
            raise ValueError(
                "num_replicas > 1 routes through the continuous-batching "
                "engine; serial_fallback has no replicas to route over")
        # remote replicas (serving/remote.py)
        for name in ("remote_connect_timeout_s", "remote_read_timeout_s",
                     "remote_digest_interval_s"):
            if not getattr(self, name) > 0.0:
                raise ValueError(f"{name} must be > 0, got "
                                 f"{getattr(self, name)}")
        if self.remote_max_retries < 0:
            raise ValueError(f"remote_max_retries must be >= 0, got "
                             f"{self.remote_max_retries}")
        if self.fleet is not None:
            addrs = [a for a in self.fleet.split(",") if a.strip()]
            if not addrs:
                raise ValueError("fleet must name at least one host:port")
            for a in addrs:
                if ":" not in a:
                    raise ValueError(f"fleet address {a!r} must be "
                                     "host:port")
            if self.serial_fallback:
                raise ValueError(
                    "fleet mode routes over remote replicas; the serial "
                    "fallback path has no router to run")
            if self.num_replicas != 1:
                raise ValueError(
                    "fleet mode and in-process replicas are exclusive: the "
                    "front tier holds no engines — drop num_replicas or "
                    "fleet")
            if self.replica_mode:
                raise ValueError(
                    "a server is either one fleet replica (replica_mode) "
                    "or the front tier over them (fleet), not both")
        if self.replica_mode and self.serial_fallback:
            raise ValueError(
                "replica_mode serves the continuous-batching engine's wire "
                "surface; the serial path has none")
        if self.engine_step_timeout_s is not None and \
                self.engine_step_timeout_s <= 0.0:
            raise ValueError("engine_step_timeout_s must be > 0")
        if self.request_deadline_s is not None and \
                self.request_deadline_s <= 0.0:
            raise ValueError("request_deadline_s must be > 0")
        if self.kv_block_size is not None:
            if self.kv_block_size < 1:
                raise ValueError("kv_block_size must be >= 1")
            if model is not None:
                cap = self.max_len or model.max_position_embeddings
                if (model.sliding_window is not None
                        and model.attention_impl == "flash"):
                    cap = min(cap, model.sliding_window)
                if cap % self.kv_block_size and self.kv_block_size < cap:
                    raise ValueError(
                        f"kv_block_size={self.kv_block_size} must divide "
                        f"the slot capacity ({cap})")
        if self.block_native_attn and model is not None \
                and model.sliding_window is not None:
            raise ValueError(
                "block_native_attn is unsupported on sliding-window "
                "models: the block kernel has no window-band mask, and "
                "rolling layouts also break its contiguous position "
                "arithmetic; sliding-window pools keep the "
                "resolve_view/scatter_view bracket. Serve this model "
                "without block_native_attn.")
        return self


@dataclass(frozen=True)
class MegatronConfig:
    """The reference's MegatronConfig without its serving section.
    `to_json` writes, and `from_dict` reads, the reference's section and
    field names, so a checkpoint's `config.json` moves between the two
    packages; sections and fields the port does not hold are ignored."""

    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)

    def validate(self, n_devices: Optional[int] = None) -> "MegatronConfig":
        """Derive the model fields, dp (from `n_devices` when given) and
        the global batch (micro batch x dp when unset), and check the mesh
        against the model as the reference does (megatron_tpu/config.py
        validate): heads, kv heads, ffn and padded vocab over tp, the
        sequence over tp under SP, the global batch over micro batch x dp;
        then the MoE routing (experts unsplit under pp), the pipeline
        fields and the resilience knobs."""
        model = self.model.derived()
        par = self.parallel
        if n_devices is not None and par.data_parallel is None:
            par = dataclasses.replace(par,
                                      data_parallel=par.derive_dp(n_devices))
        tp, dp = par.tensor_parallel, par.data_parallel or 1
        cp = par.context_parallel
        if tp < 1 or dp < 1 or cp < 1:
            raise ValueError(f"tp={tp}, dp={dp} and cp={cp} must be >= 1")
        nq, nkv = model.num_attention_heads, model.num_kv_heads
        if nq % tp:
            raise ValueError(f"attention heads {nq} must shard evenly over "
                             f"tp={tp}")
        if nkv % tp and tp % nkv:
            raise ValueError(f"kv heads {nkv} must shard evenly over tp={tp} "
                             "or divide it (then they are replicated)")
        if model.ffn_hidden_size % tp:
            raise ValueError(f"ffn_hidden_size {model.ffn_hidden_size} must "
                             f"shard evenly over tp={tp}")
        if model.padded_vocab_size % tp:
            raise ValueError(f"padded vocab {model.padded_vocab_size} must "
                             f"shard evenly over tp={tp}")
        if par.sequence_parallel and model.seq_length % tp:
            raise ValueError("sequence parallel requires seq_length "
                             f"{model.seq_length} divisible by tp={tp}")
        sp_tp = tp if par.sequence_parallel else 1
        if cp > 1 and model.seq_length % (cp * sp_tp):
            raise ValueError(f"context parallel requires seq_length "
                             f"{model.seq_length} divisible by cp={cp}"
                             + (f" x tp={tp}" if sp_tp > 1 else ""))
        self._check_context_parallel(model, par)
        tr = self.training
        if tr.global_batch_size is None:
            tr = dataclasses.replace(
                tr, global_batch_size=tr.micro_batch_size * dp)
        if tr.global_batch_size % (tr.micro_batch_size * dp):
            raise ValueError(f"global batch {tr.global_batch_size} must be "
                             f"divisible by micro batch x dp "
                             f"{tr.micro_batch_size * dp}")
        if model.num_experts > 1:
            if not 1 <= model.moe_top_k <= model.num_experts:
                raise ValueError(f"moe_top_k={model.moe_top_k} must be in "
                                 f"[1, num_experts={model.num_experts}]")
            if model.moe_dispatch not in ("sort", "dense"):
                raise ValueError(f"moe_dispatch={model.moe_dispatch!r} "
                                 "(expected 'sort' or 'dense')")
            if par.expert_axis not in ("tp", "dp"):
                raise ValueError(f"expert_axis={par.expert_axis!r} "
                                 "(expected 'tp' or 'dp')")
            ep = tp if par.expert_axis == "tp" else par.data_parallel
            if ep is None and par.pipeline_parallel > 1:
                raise ValueError(
                    "expert_axis='dp' with pipeline_parallel>1 needs dp "
                    "known at validate time — pass n_devices to "
                    "validate() or set ParallelConfig.data_parallel")
            ep = ep or 1
            if model.num_experts % ep:
                raise ValueError(
                    f"num_experts={model.num_experts} must shard evenly "
                    f"over the '{par.expert_axis}' mesh axis (size {ep}) "
                    "— parallel/sharding.py 'experts' rule")
            if par.pipeline_parallel > 1 and ep != 1:
                raise ValueError(
                    f"MoE with pipeline_parallel={par.pipeline_parallel} "
                    "requires the expert mesh axis be unsplit (got "
                    f"'{par.expert_axis}' size {ep}), as the reference "
                    "does. Use pp=1 for expert parallelism, or pp>1 with "
                    "tensor_parallel=1 / expert_axis='tp'-on-tp1")
        par = self._check_pipeline(model, par)
        self.resilience.validate()
        return dataclasses.replace(self, model=model, parallel=par,
                                   training=tr)

    @staticmethod
    def _check_pipeline(model: "ModelConfig",
                        par: ParallelConfig) -> ParallelConfig:
        """The reference's pipeline checks: the stages split the layers,
        the virtual chunks a stage's, the schedule is known; store mode
        under gpipe is dropped with a warning."""
        pp, vpp = par.pipeline_parallel, par.virtual_pipeline_chunks
        if pp < 1 or vpp < 1:
            raise ValueError(f"pipeline_parallel={pp} and "
                             f"virtual_pipeline_chunks={vpp} must be >= 1")
        if model.num_layers % pp:
            raise ValueError(f"num_layers {model.num_layers} must divide "
                             f"evenly into pp={pp} stages")
        if vpp > 1 and (model.num_layers // pp) % vpp:
            raise ValueError(f"a stage's {model.num_layers // pp} layers "
                             f"must divide evenly into {vpp} virtual "
                             "chunks")
        if par.pipeline_schedule not in ("1f1b", "gpipe"):
            raise ValueError(
                f"unknown pipeline_schedule {par.pipeline_schedule!r}")
        if par.pipeline_store_activations and \
                par.pipeline_schedule != "1f1b":
            from megatron_tpu_torch.utils.logging import print_rank_0
            print_rank_0(
                "warning: --pipeline_store_activations only applies to "
                "the 1f1b schedule; ignoring it for "
                f"pipeline_schedule={par.pipeline_schedule!r}")
            par = dataclasses.replace(par,
                                      pipeline_store_activations=False)
        return par

    @staticmethod
    def _check_context_parallel(model: "ModelConfig",
                                par: ParallelConfig) -> None:
        """The reference's ring/Ulysses checks and warnings
        (megatron_tpu/config.py validate)."""
        from megatron_tpu_torch.utils.logging import print_rank_0
        impl = model.attention_impl
        if model.sliding_window is not None and impl in ("ring", "ulysses"):
            print_rank_0(
                f"warning: attention_impl={impl!r} has no sliding-window "
                "plumbing — attention gathers the sequence over cp and "
                "runs the flash kernel on it; use attention_impl=flash "
                "for banded attention")
        if impl in ("ring", "ulysses") and model.attention_dropout > 0.0:
            print_rank_0(
                f"warning: attention_impl={impl!r} with attention_dropout="
                f"{model.attention_dropout} gathers the sequence over cp "
                "during training (the cp rings have no dropout plumbing); "
                "eval keeps the ring, and attention_impl=flash carries "
                "dropout natively")
        cp = par.context_parallel
        if impl == "ulysses" and cp > 1:
            nq, nkv = model.num_attention_heads, model.num_kv_heads
            tp = par.tensor_parallel
            if nq % cp or nkv % cp:
                raise ValueError(
                    f"ulysses needs query AND kv head counts divisible by "
                    f"cp={cp} (got nq={nq}, nkv={nkv}); use "
                    "--context_parallel_algo ring")
            if (nq // tp) % cp or (nkv % tp == 0 and (nkv // tp) % cp):
                raise ValueError(
                    f"ulysses splits each tp rank's heads over cp: nq/tp="
                    f"{nq // tp} and nkv/tp={max(nkv // tp, 1)} must divide "
                    f"by cp={cp}; use --context_parallel_algo ring")
            if nkv % tp:
                raise ValueError(
                    f"ulysses with kv heads replicated over tp (nkv={nkv} < "
                    f"tp={tp}) leaves one kv head a rank, which does not "
                    f"split over cp={cp}; use --context_parallel_algo ring")

    @property
    def num_microbatches(self) -> int:
        tr = self.training
        per_step = tr.micro_batch_size * (self.parallel.data_parallel or 1)
        gbs = tr.global_batch_size or per_step
        if gbs % per_step:
            raise ValueError(f"global batch {gbs} must be divisible by "
                             f"micro batch x dp {per_step}")
        return gbs // per_step

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MegatronConfig":
        def build(cls, sub):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in sub.items() if k in names})
        return MegatronConfig(
            model=build(ModelConfig, d.get("model", {})),
            parallel=build(ParallelConfig, d.get("parallel", {})),
            optimizer=build(OptimizerConfig, d.get("optimizer", {})),
            training=build(TrainingConfig, d.get("training", {})),
            data=build(DataConfig, d.get("data", {})),
            resilience=build(ResilienceConfig, d.get("resilience", {})))


# ---------------------------------------------------------------------------
# Model presets (megatron_tpu/config.py llama2_config .. MODEL_PRESETS)
# ---------------------------------------------------------------------------

def llama2_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(num_layers=2, hidden_size=256, num_attention_heads=4,
                     vocab_size=32000, seq_length=512,
                     attention_impl="dot"),
        "7b": dict(num_layers=32, hidden_size=4096, num_attention_heads=32,
                   ffn_hidden_size=11008, vocab_size=32000, seq_length=4096),
        "13b": dict(num_layers=40, hidden_size=5120, num_attention_heads=40,
                    ffn_hidden_size=13824, vocab_size=32000, seq_length=4096),
        "70b": dict(num_layers=80, hidden_size=8192, num_attention_heads=64,
                    num_kv_heads=8, ffn_hidden_size=28672, vocab_size=32000,
                    seq_length=4096),
    }
    base = dict(
        use_rotary_emb=True, norm_type="rmsnorm", norm_epsilon=1e-5,
        activation="swiglu", use_bias=False, use_post_ln=False,
        parallel_attn=False, tie_embed_logits=False,
        # real-model presets take the flash path; the "tiny" presets keep
        # dot, as in the reference
        attention_impl="flash",
    )
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base).derived()


def falcon_config(size: str = "7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(num_layers=2, hidden_size=256, num_attention_heads=4,
                     num_kv_heads=1, vocab_size=65024, seq_length=512,
                     attention_impl="dot"),
        "7b": dict(num_layers=32, hidden_size=4544, num_attention_heads=71,
                   num_kv_heads=1, vocab_size=65024, seq_length=2048),
        "40b": dict(num_layers=60, hidden_size=8192, num_attention_heads=128,
                    num_kv_heads=8, vocab_size=65024, seq_length=2048,
                    parallel_layernorm=True),
    }
    base = dict(
        use_rotary_emb=True, norm_type="layernorm", norm_epsilon=1e-5,
        activation="gelu", use_bias=False, use_post_ln=False,
        parallel_attn=True, tie_embed_logits=True,
        attention_impl="flash",
    )
    base.update(presets[size])
    base.update(overrides)
    return ModelConfig(**base).derived()


def mixtral_config(size: str = "8x7b", **overrides) -> ModelConfig:
    presets = {
        "tiny": dict(num_layers=2, hidden_size=256, num_attention_heads=8,
                     num_kv_heads=2, ffn_hidden_size=512, vocab_size=32000,
                     seq_length=512, num_experts=4, attention_impl="dot"),
        "8x7b": dict(num_layers=32, hidden_size=4096,
                     num_attention_heads=32, num_kv_heads=8,
                     ffn_hidden_size=14336, vocab_size=32000,
                     seq_length=4096, max_position_embeddings=32768,
                     num_experts=8),
    }
    if size not in presets:
        raise ValueError(f"unknown mixtral size {size!r}; "
                         f"valid: {sorted(presets)}")
    base = dict(
        use_rotary_emb=True, rope_theta=1e6, norm_type="rmsnorm",
        norm_epsilon=1e-5, activation="swiglu", use_bias=False,
        use_post_ln=False, tie_embed_logits=False, moe_top_k=2,
        attention_impl="flash",
    )
    base.update(presets[size])
    base.update(overrides)
    base.setdefault("moe_capacity_factor",
                    base["num_experts"] / base["moe_top_k"])
    return ModelConfig(**base).derived()


def gpt_config(**overrides) -> ModelConfig:
    base = dict(
        num_layers=12, hidden_size=768, num_attention_heads=12,
        vocab_size=50257, seq_length=1024, use_rotary_emb=False,
        use_position_embedding=True, norm_type="layernorm",
        activation="gelu", use_bias=True, tie_embed_logits=True,
    )
    base.update(overrides)
    return ModelConfig(**base).derived()


MODEL_PRESETS = {
    "llama2-tiny": lambda: llama2_config("tiny"),
    "llama2-7b": lambda: llama2_config("7b"),
    "llama2-13b": lambda: llama2_config("13b"),
    "llama2-70b": lambda: llama2_config("70b"),
    "falcon-tiny": lambda: falcon_config("tiny"),
    "falcon-7b": lambda: falcon_config("7b"),
    "falcon-40b": lambda: falcon_config("40b"),
    "mixtral-tiny": lambda: mixtral_config("tiny"),
    "mixtral-8x7b": lambda: mixtral_config("8x7b"),
    "gpt2": gpt_config,
}
