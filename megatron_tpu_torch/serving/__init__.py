"""Continuous-batching serving (megatron_tpu/serving): the engine, its KV
pool, the prefix index, the host KV tier, the draft side of speculative
decoding, the admission scheduler, the prefix-affinity router over engine
replicas, request objects and metrics, the grammar compiler of structured
output, the brownout ladder and the invariant checker."""
from megatron_tpu_torch.serving.degrade import (  # noqa: F401
    DEFAULT_RAISE_AT, DegradeController)
from megatron_tpu_torch.serving.engine import (  # noqa: F401
    EngineHungError, ServingEngine)
from megatron_tpu_torch.serving.host_tier import HostKVTier  # noqa: F401
from megatron_tpu_torch.serving.invariants import (  # noqa: F401
    InvariantViolation, check_all, check_degrade_revert,
    check_goodput_floor, check_grammar_validity, check_kv_accounting,
    check_metrics_conservation, check_schema, check_shed_monotone,
    check_slo_bounds, check_token_exact, resolve_terminals)
from megatron_tpu_torch.serving.kv_pool import (  # noqa: F401
    BlockKV, RetainedPrefix, SlotKVPool, block_native_cache, clone_prefix,
    insert_blocks, insert_prefill, pack_block_native, resolve_view,
    scatter_view, slice_blocks, slice_slot)
from megatron_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from megatron_tpu_torch.serving.prefix_index import PrefixIndex  # noqa: F401
from megatron_tpu_torch.serving.request import (  # noqa: F401
    DeadlineExceededError, FanoutRequest, GenRequest, GrammarDeadEndError,
    RequestFailedError, RequestState, SamplingOptions,
    ServiceUnavailableError)
from megatron_tpu_torch.serving.router import (  # noqa: F401
    EngineRouter, NoReplicaAvailableError)
from megatron_tpu_torch.serving.scheduler import (  # noqa: F401
    AdmissionError, AdmissionScheduler, EngineUnhealthyError,
    OverloadShedError, QueueFullError)
from megatron_tpu_torch.serving.spec_decode import (  # noqa: F401
    Drafter, NGramDrafter)
from megatron_tpu_torch.serving.structured import (  # noqa: F401
    CharDFA, GrammarCompileError, TokenFSM, compile_regex,
    compile_response_format, schema_to_regex, validate_response_format)
