"""megatron_tpu_torch: the PyTorch/CUDA port of megatron_tpu for NVIDIA
Hopper.

The package mirrors megatron_tpu's module paths and function names and
imports neither JAX nor megatron_tpu. Its entry points (LanguageModel,
Generator, ServingEngine, MegatronServer, finetune.main) run on the current
CUDA device unless the caller passes another `device`, and raise when no
GPU is present and none was named.
"""
from megatron_tpu_torch.config import (MODEL_PRESETS,  # noqa: F401
                                       ModelConfig, falcon_config,
                                       llama2_config)
from megatron_tpu_torch.models.language_model import (  # noqa: F401
    LanguageModel, model_forward)
