from megatron_tpu_torch.inference.api import (  # noqa: F401
    beam_search_and_post_process, generate_and_post_process)
from megatron_tpu_torch.inference.generation import (  # noqa: F401
    Generator, SamplingParams, beam_search, init_kv_caches)
from megatron_tpu_torch.inference.sampling import sample  # noqa: F401
