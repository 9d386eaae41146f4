"""The GPT data path (megatron_tpu/data): the `.bin/.idx` indexed dataset,
the doc/sample/shuffle index mappings, blending, the samplers and batch
iterators with their exact-resume state, and the tokenizers. Host numpy
and plain Python; the native helper is host C++ (data/helpers.cpp)."""
from megatron_tpu_torch.data.indexed_dataset import (  # noqa: F401
    DatasetCorruptionError, IndexedDatasetBuilder, MMapIndexedDataset,
    best_fitting_dtype, infer_dataset_exists, make_dataset)
from megatron_tpu_torch.data.gpt_dataset import (  # noqa: F401
    GPTDataset, build_train_valid_test_datasets, get_train_valid_test_split_)
from megatron_tpu_torch.data.blendable import BlendableDataset  # noqa: F401
from megatron_tpu_torch.data.samplers import (  # noqa: F401
    BatchIterator, DictBatchIterator, MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler, PrefetchIterator,
    get_ltor_masks_and_position_ids, restore_data_state)
from megatron_tpu_torch.data.tokenizers import build_tokenizer  # noqa: F401
