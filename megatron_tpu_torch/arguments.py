"""The Megatron CLI flags of the pretraining path -> MegatronConfig
(megatron_tpu/arguments.py).

The flags keep the reference's names and defaults, so a launch line of
`finetune.py` runs `python -m megatron_tpu_torch.finetune` unchanged. The
port parses the model, training, optimizer, data and resilience groups and
the reference-compat aliases of this path.
`--tensor_model_parallel_size`, `--pipeline_model_parallel_size`,
`--context_parallel_size`, `--sequence_parallel`,
`--use_distributed_optimizer` and `--expert_axis` shard the step over a
(dp, pp, cp, tp) mesh of the ranks that torchrun starts
(`parse_cli(n_devices=...)` derives dp from their count);
`--num_layers_per_virtual_pipeline_stage` sets the virtual chunks (a
stage's layers over it, as the reference derives them),
`--pipeline_schedule` 1f1b or gpipe and `--pipeline_store_activations`
the 1F1B's store mode;
`--context_parallel_algo` picks ring or Ulysses attention for cp > 1, and
`--distributed_backend` names the process group's backend (nccl on CUDA
devices by default, gloo).
`--recompute_granularity full|selective` recomputes each layer in the
backward (models/transformer.py); `--recompute_activations` is the
reference's alias for selective, and `--recompute_method` and
`--recompute_num_layers` are accepted and change nothing, as in the
reference, which recomputes every layer alike. `--bf16` and `--fp16` on
the flag-built path train bf16 and fp16 master weights. The MoE flags
(`--num_experts`,
`--moe_top_k`, `--moe_capacity_factor`, `--moe_aux_loss_coeff`,
`--moe_dispatch`) keep the reference's defaults.
`--lora_rank` (with `--lora_alpha` and `--lora_export`) turns the run into
a LoRA finetune (training/lora.py). `--mask_prob`, `--short_seq_prob` and
`--decoder_seq_length` feed the masked-LM datasets of pretrain_bert and
pretrain_t5; `--decoder_num_layers` is accepted as the reference's T5
launch lines carry it, and the decoder has `--num_layers` layers as in the
JAX package. The serving
flags belong to the serving entry point and are not parsed here; the
reference's CUDA-mechanics flags are accepted and have no effect.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

from megatron_tpu_torch.config import (MODEL_PRESETS, DataConfig,
                                       MegatronConfig, ModelConfig,
                                       OptimizerConfig, ParallelConfig,
                                       ResilienceConfig, TrainingConfig)
from megatron_tpu_torch.utils.logging import print_rank_0


def build_parser(extra_args_provider: Optional[Callable] = None
                 ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="megatron_tpu_torch",
                                allow_abbrev=False)

    g = p.add_argument_group("model")
    # default None: an explicit "--num_layers 2" beats a preset's depth
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=128)
    g.add_argument("--ffn_hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=4)
    g.add_argument("--num_attention_heads_kv", type=int, default=None,
                   dest="num_kv_heads")
    g.add_argument("--kv_channels", type=int, default=None)
    g.add_argument("--seq_length", type=int, default=None)
    g.add_argument("--max_position_embeddings", type=int, default=None)
    g.add_argument("--make_vocab_size_divisible_by", type=int, default=128)
    g.add_argument("--layernorm_epsilon", type=float, default=1e-5,
                   dest="norm_epsilon")
    g.add_argument("--use_rms_norm", action="store_true")
    g.add_argument("--use_post_ln", action="store_true")
    g.add_argument("--use_bias", action="store_true")
    g.add_argument("--parallel_attn", action="store_true")
    g.add_argument("--parallel_layernorm", action="store_true")
    g.add_argument("--use_rotary_emb", action="store_true", default=True)
    g.add_argument("--no_rotary_emb", dest="use_rotary_emb",
                   action="store_false")
    g.add_argument("--position_embedding", action="store_true",
                   dest="use_position_embedding")
    g.add_argument("--rope_theta", type=float, default=10000.0)
    g.add_argument("--sliding_window", type=int, default=None)
    g.add_argument("--rope_scaling_factor", type=float, default=1.0)
    g.add_argument("--glu_activation", type=str, default=None,
                   choices=["swiglu", "geglu", "reglu", "liglu"])
    g.add_argument("--activation", type=str, default=None)
    g.add_argument("--hidden_dropout", type=float, default=0.0)
    g.add_argument("--attention_dropout", type=float, default=0.0)
    g.add_argument("--lima_dropout", action="store_true")
    g.add_argument("--drop_path_rate", type=float, default=0.0)
    g.add_argument("--tie_embed_logits", action="store_true")
    g.add_argument("--init_method_std", type=float, default=0.02)
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--fp32", action="store_true")
    g.add_argument("--use_flash_attn", action="store_true")
    g.add_argument("--attention_impl", type=str, default=None,
                   choices=["dot", "flash", "ring", "ulysses"])
    g.add_argument("--recompute_granularity", type=str, default="none",
                   choices=["none", "selective", "full"])
    # Mixture-of-Experts (models/moe.py)
    g.add_argument("--num_experts", type=int, default=1)
    g.add_argument("--moe_top_k", type=int, default=2)
    g.add_argument("--moe_capacity_factor", type=float, default=1.25)
    g.add_argument("--moe_aux_loss_coeff", type=float, default=1e-2)
    g.add_argument("--moe_dispatch", type=str, default="sort",
                   choices=["sort", "dense"])
    g.add_argument("--model", type=str, default=None,
                   help="preset name (llama2-7b, falcon-7b, gpt2, ...)")

    g = p.add_argument_group("parallel")
    g.add_argument("--tensor_model_parallel_size", type=int, default=1,
                   dest="tensor_parallel")
    g.add_argument("--pipeline_model_parallel_size", type=int, default=1,
                   dest="pipeline_parallel")
    g.add_argument("--context_parallel_size", type=int, default=1,
                   dest="context_parallel")
    g.add_argument("--num_layers_per_virtual_pipeline_stage", type=int,
                   default=None)
    g.add_argument("--pipeline_schedule", type=str, default="1f1b",
                   choices=["1f1b", "gpipe"])
    g.add_argument("--pipeline_store_activations", action="store_true")
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--use_distributed_optimizer", action="store_true")
    g.add_argument("--expert_axis", type=str, default="tp",
                   choices=["tp", "dp"])
    g.add_argument("--context_parallel_algo", type=str, default="ring",
                   choices=["ring", "ulysses"])
    g.add_argument("--distributed_backend", type=str, default=None,
                   choices=["nccl", "gloo"])

    g = p.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--rampup_batch_size", nargs=3, type=int, default=None)
    g.add_argument("--train_iters", type=int, default=100)
    g.add_argument("--eval_interval", type=int, default=1000)
    g.add_argument("--eval_iters", type=int, default=10)
    g.add_argument("--log_interval", type=int, default=10)
    g.add_argument("--save_interval", type=int, default=None)
    g.add_argument("--exit_interval", type=int, default=None)
    g.add_argument("--exit_duration_in_mins", type=float, default=None)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--profile", action="store_true",
                   help="torch.profiler trace over [profile_step_start, "
                        "profile_step_end]")
    g.add_argument("--profile_step_start", type=int, default=10)
    g.add_argument("--profile_step_end", type=int, default=12)
    g.add_argument("--profile_dir", type=str, default=None)
    g.add_argument("--save", type=str, default=None, dest="checkpoint_dir")
    g.add_argument("--load", type=str, default=None, dest="load_dir")
    g.add_argument("--finetune", action="store_true")
    g.add_argument("--no_load_optim", action="store_true")
    g.add_argument("--no_load_rng", action="store_true")
    g.add_argument("--use_checkpoint_args", action="store_true")
    g.add_argument("--wandb_logger", action="store_true")
    g.add_argument("--tensorboard_dir", type=str, default=None)
    g.add_argument("--sync_metrics", action="store_true",
                   help="fetch the step's metrics every iteration instead "
                        "of once per log window")

    g = p.add_argument_group("optimizer")
    g.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "sgd"])
    g.add_argument("--lr", type=float, default=3e-4)
    g.add_argument("--min_lr", type=float, default=0.0)
    g.add_argument("--lr_decay_style", type=str, default="cosine")
    g.add_argument("--lr_decay_iters", type=int, default=None)
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--lr_warmup_fraction", type=float, default=None)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--start_weight_decay", type=float, default=None)
    g.add_argument("--end_weight_decay", type=float, default=None)
    g.add_argument("--weight_decay_incr_style", type=str, default="constant")
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--adam_eps", type=float, default=1e-8)
    g.add_argument("--sgd_momentum", type=float, default=0.9)
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--loss_scale", type=float, default=None)
    g.add_argument("--initial_loss_scale", type=float, default=2.0 ** 32)
    g.add_argument("--min_loss_scale", type=float, default=1.0)
    g.add_argument("--loss_scale_window", type=int, default=1000)
    g.add_argument("--hysteresis", type=int, default=2)
    g.add_argument("--log_num_zeros_in_grad", action="store_true")

    g = p.add_argument_group("data")
    g.add_argument("--data_path", nargs="*", default=None)
    g.add_argument("--split", type=str, default="969,30,1")
    g.add_argument("--tokenizer_type", type=str,
                   default="SentencePieceTokenizer")
    g.add_argument("--vocab_file", type=str, default=None)
    g.add_argument("--merge_file", type=str, default=None)
    g.add_argument("--tokenizer_model", type=str, default=None)
    g.add_argument("--vocab_size", type=int, default=32000)
    g.add_argument("--dataloader_type", type=str, default="single",
                   choices=["single", "cyclic"])
    g.add_argument("--num_workers", type=int, default=2)
    g.add_argument("--reset_position_ids", action="store_true")
    g.add_argument("--reset_attention_mask", action="store_true")
    g.add_argument("--eod_mask_loss", action="store_true")
    g.add_argument("--vocab_extra_ids", type=int, default=0)
    g.add_argument("--vocab_extra_ids_list", type=str, default=None)
    g.add_argument("--no_new_tokens", dest="new_tokens",
                   action="store_false", default=True)
    g.add_argument("--data_impl", type=str, default="mmap")
    g.add_argument("--strict_data", action="store_true")
    # the masked-LM datasets of pretrain_bert / pretrain_t5
    g.add_argument("--mask_prob", type=float, default=0.15,
                   dest="masked_lm_prob")
    g.add_argument("--short_seq_prob", type=float, default=0.1)
    g.add_argument("--train_data_path", nargs="*", default=None)
    g.add_argument("--valid_data_path", nargs="*", default=None)
    g.add_argument("--test_data_path", nargs="*", default=None)

    g = p.add_argument_group("resilience")
    g.add_argument("--no_checkpoint_integrity", action="store_true")
    g.add_argument("--keep_last_k", type=int, default=None)
    g.add_argument("--io_retries", type=int, default=4)
    g.add_argument("--io_backoff_s", type=float, default=0.5)
    g.add_argument("--io_backoff_max_s", type=float, default=30.0)
    g.add_argument("--max_consecutive_nonfinite", type=int, default=3)
    g.add_argument("--loss_spike_factor", type=float, default=None)
    g.add_argument("--loss_spike_window", type=int, default=32)
    g.add_argument("--max_rollbacks", type=int, default=2)
    g.add_argument("--step_timeout_s", type=float, default=None)
    g.add_argument("--watchdog_exit_code", type=int, default=43)
    g.add_argument("--lora_rank", type=int, default=0)
    g.add_argument("--lora_alpha", type=float, default=16.0)
    g.add_argument("--lora_export", type=str, default=None)

    g = p.add_argument_group("reference compat")
    g.add_argument("--train_samples", type=int, default=None)
    g.add_argument("--lr_decay_samples", type=int, default=None)
    g.add_argument("--lr_warmup_samples", type=int, default=None)
    g.add_argument("--position_embedding_type", type=str, default=None,
                   choices=["rope", "rotary", "learned_absolute",
                            "absolute"])
    g.add_argument("--encoder_num_layers", type=int, default=None)
    g.add_argument("--encoder_seq_length", type=int, default=None)
    g.add_argument("--decoder_num_layers", type=int, default=None)
    g.add_argument("--decoder_seq_length", type=int, default=128,
                   dest="max_seq_length_dec")
    g.add_argument("--no_save_optim", action="store_true")
    g.add_argument("--no_save_rng", action="store_true")
    g.add_argument("--recompute_activations", action="store_true",
                   help="alias for --recompute_granularity selective, "
                        "which keeps each layer's weight-GEMM outputs and "
                        "recomputes the rest (more memory than full, no "
                        "GEMM run twice)")
    g.add_argument("--recompute_method", type=str, default=None,
                   choices=["uniform", "block"],
                   help="accepted; every layer is recomputed alike either "
                        "way")
    g.add_argument("--recompute_num_layers", type=int, default=None)
    g.add_argument("--attention_softmax_in_fp32", action="store_true",
                   dest="softmax_compute_fp32", default=True)
    g.add_argument("--exit_signal_handler", action="store_true")
    g.add_argument("--override_opt_param_scheduler", action="store_true")
    g.add_argument("--use_checkpoint_opt_param_scheduler",
                   action="store_true")
    g.add_argument("--log_params_norm", action="store_true")
    g.add_argument("--log_timers_to_tensorboard", action="store_true")
    g.add_argument("--log_validation_ppl_to_tensorboard",
                   action="store_true")
    g.add_argument("--wandb_project", type=str, default=None)
    g.add_argument("--wandb_entity", type=str, default=None)
    g.add_argument("--wandb_id", type=str, default=None)
    g.add_argument("--wandb_resume", action="store_true")
    for flag in _NOOP_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)

    if extra_args_provider is not None:
        p = extra_args_provider(p)
    return p


# Reference flags that tune mechanisms neither package has (fused-kernel
# toggles, DDP and NCCL knobs, fp8/Transformer Engine, ADLR autoresume):
# accepted so that reference launch lines run, with a logged note.
_NOOP_FLAGS = [
    "--DDP_impl", "--accumulate_allreduce_grads_in_fp32",
    "--adlr_autoresume", "--adlr_autoresume_interval",
    "--barrier_with_L1_time", "--apply_residual_connection_post_layernorm",
    "--data_parallel_random_init", "--distribute_saved_activations",
    "--empty_unused_memory_level",
    "--fp16_lm_cross_entropy", "--fp32_residual_connection",
    "--fp8_amax_compute_algo", "--fp8_amax_history_len", "--fp8_e4m3",
    "--fp8_hybrid", "--fp8_interval", "--fp8_margin", "--no_fp8_wgrad",
    "--init_method_xavier_uniform", "--local_rank",
    "--log_batch_size_to_tensorboard", "--log_memory_to_tensorboard",
    "--log_world_size_to_tensorboard",
    "--no_async_tensor_model_parallel_allreduce",
    "--no_bias_dropout_fusion", "--no_bias_gelu_fusion",
    "--no_contiguous_buffers_in_local_ddp", "--no_data_sharding",
    "--no_gradient_accumulation_fusion", "--no_initialization",
    "--mmap_warmup", "--no_masked_softmax_fusion", "--no_persist_layer_norm",
    "--no_query_key_layer_scaling", "--no_scatter_gather_tensors_in_pipeline",
    "--tensorboard_log_interval", "--tensorboard_queue_size",
    "--timing_log_level", "--timing_log_option", "--transformer_impl",
    "--use_cpu_initialization", "--use_ring_exchange_p2p",
]

def _pick(ns: argparse.Namespace, cls) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in vars(ns).items() if k in names}


def _apply_compat(args: argparse.Namespace) -> None:
    """Reference-compat aliases -> the native flags; note the accepted
    no-op flags. Idempotent."""
    if not hasattr(args, "_num_layers_defaulted"):
        args._num_layers_defaulted = False
        if args.num_layers is None:
            enc = args.encoder_num_layers
            args.num_layers = enc if enc is not None else 2
            args._num_layers_defaulted = enc is None
    if args.encoder_seq_length and not args.seq_length:
        args.seq_length = args.encoder_seq_length
    if args.recompute_activations and args.recompute_granularity == "none":
        args.recompute_granularity = "selective"
    pet = args.position_embedding_type
    if pet in ("rope", "rotary"):
        args.use_rotary_emb = True
    elif pet in ("learned_absolute", "absolute"):
        args.use_rotary_emb = False
        args.use_position_embedding = True
    if args.train_samples:
        if args.rampup_batch_size is not None:
            raise ValueError("--train_samples with --rampup_batch_size is "
                             "not supported; use --train_iters")
        if not args.global_batch_size:
            raise ValueError("--train_samples needs an explicit "
                             "--global_batch_size")
        gbs = args.global_batch_size
        args.train_iters = -(-args.train_samples // gbs)
        if args.lr_decay_samples and not args.lr_decay_iters:
            args.lr_decay_iters = -(-args.lr_decay_samples // gbs)
        if args.lr_warmup_samples and not args.lr_warmup_iters:
            args.lr_warmup_iters = -(-args.lr_warmup_samples // gbs)
    if args.data_path and args.train_data_path:
        raise SystemExit("--data_path and --train_data_path are mutually "
                         "exclusive — pick one train corpus")
    set_noops = [f for f in _NOOP_FLAGS
                 if getattr(args, f.lstrip("-"), None) is not None]
    if set_noops:
        print_rank_0("compat: accepted with no effect: "
                     + ", ".join(set_noops))


def config_from_args(args: argparse.Namespace,
                     defaults: Optional[dict] = None,
                     n_devices: Optional[int] = None) -> MegatronConfig:
    _apply_compat(args)
    if args.model:
        model = MODEL_PRESETS[args.model]()
        # a preset is a baseline: every model-field flag set away from the
        # parser's default overrides it (an explicit --num_layers too)
        overrides = {}
        if defaults:
            handled = {"seq_length", "recompute_granularity",
                       "attention_impl"}
            for f in dataclasses.fields(type(model)):
                if f.name in handled or f.name not in defaults:
                    continue
                if f.name == "num_layers" and args._num_layers_defaulted:
                    continue
                v = getattr(args, f.name, None)
                if v != defaults[f.name]:
                    overrides[f.name] = v
        model = dataclasses.replace(
            model, seq_length=args.seq_length or model.seq_length,
            recompute_granularity=args.recompute_granularity,
            attention_impl=(args.attention_impl or
                            ("flash" if args.use_flash_attn
                             else model.attention_impl)), **overrides)
    else:
        activation = (args.glu_activation or args.activation or
                      ("swiglu" if args.use_rms_norm else "gelu"))
        md = _pick(args, ModelConfig)
        if md.get("seq_length") is None:
            md["seq_length"] = 512
        md.update(dict(
            norm_type="rmsnorm" if args.use_rms_norm else "layernorm",
            activation=activation,
            params_dtype=("bfloat16" if args.bf16 else
                          "float16" if args.fp16 else "float32"),
            compute_dtype="bfloat16" if args.bf16 or args.fp16 else "float32",
            attention_impl=(args.attention_impl or
                            ("flash" if args.use_flash_attn else "dot"))))
        model = ModelConfig(**md)
    if args.context_parallel > 1 and \
            model.attention_impl not in ("ring", "ulysses"):
        # cp > 1 needs a context-parallel attention; the algo flag picks
        # ring or Ulysses (both run the flash kernels inside)
        model = dataclasses.replace(
            model, attention_impl=args.context_parallel_algo)
    vpp = 1
    if args.num_layers_per_virtual_pipeline_stage:
        per_stage = model.num_layers // max(args.pipeline_parallel, 1)
        vpp = per_stage // args.num_layers_per_virtual_pipeline_stage
    cfg = MegatronConfig(
        model=model,
        parallel=ParallelConfig(
            tensor_parallel=args.tensor_parallel,
            pipeline_parallel=args.pipeline_parallel,
            context_parallel=args.context_parallel,
            expert_axis=args.expert_axis,
            sequence_parallel=args.sequence_parallel,
            virtual_pipeline_chunks=vpp,
            pipeline_schedule=args.pipeline_schedule,
            pipeline_store_activations=args.pipeline_store_activations,
            use_distributed_optimizer=args.use_distributed_optimizer),
        optimizer=OptimizerConfig(**_pick(args, OptimizerConfig)),
        training=TrainingConfig(**{
            **_pick(args, TrainingConfig),
            "rampup_batch_size": tuple(args.rampup_batch_size)
            if args.rampup_batch_size else None}),
        data=DataConfig(**_pick(args, DataConfig)),
        resilience=ResilienceConfig(**{
            **_pick(args, ResilienceConfig),
            "checkpoint_integrity": not args.no_checkpoint_integrity}))
    return cfg.validate(n_devices=n_devices)


def parse_cli(argv=None, extra_args_provider=None,
              n_devices: Optional[int] = None
              ) -> tuple[MegatronConfig, argparse.Namespace]:
    """The flags -> a validated MegatronConfig, dp derived from
    `n_devices` (the number of ranks) when given."""
    parser = build_parser(extra_args_provider)
    args = parser.parse_args(argv)
    defaults = {a.dest: a.default for a in parser._actions}
    return config_from_args(args, defaults=defaults,
                            n_devices=n_devices), args
