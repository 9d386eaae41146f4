"""Continuous-batching serving (megatron_tpu/serving): the engine, its KV
pool, admission scheduler, request objects and metrics."""
from megatron_tpu_torch.serving.engine import (  # noqa: F401
    EngineHungError, ServingEngine)
from megatron_tpu_torch.serving.kv_pool import (  # noqa: F401
    BlockKV, RetainedPrefix, SlotKVPool, block_native_cache, insert_blocks,
    insert_prefill, pack_block_native, resolve_view, scatter_view,
    slice_blocks)
from megatron_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from megatron_tpu_torch.serving.request import (  # noqa: F401
    DeadlineExceededError, GenRequest, RequestFailedError, RequestState,
    SamplingOptions, ServiceUnavailableError)
from megatron_tpu_torch.serving.scheduler import (  # noqa: F401
    AdmissionError, AdmissionScheduler, EngineUnhealthyError,
    OverloadShedError, QueueFullError)
