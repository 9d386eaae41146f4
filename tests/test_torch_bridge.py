"""The weight bridge and the port's package boundaries.

- `params_from_numpy` keeps the JAX parameter tree's names and shapes (a
  Mixtral's expert banks too);
- a checkpoint the JAX package saved with backend="npz" loads without JAX
  and gives the same logits;
- no module of the port (nor chip_smoke.py) imports jax or megatron_tpu,
  nor transformers, safetensors, tokenizers, sentencepiece, regex or
  requests, which the card's machine lacks;
- the entry points refuse to fall back to the CPU when no device is named,
  and the block-attention kernel's wrapper refuses a CPU tensor.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training.checkpointing import _flatten, save_checkpoint
from megatron_tpu.training.train_step import TrainState
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.convert.from_jax import (load_npz_checkpoint,
                                                 params_from_numpy)
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import (LanguageModel,
                                                      model_forward)
from megatron_tpu_torch.ops.block_attention import block_native_attention
from megatron_tpu_torch.ops.block_attention_cuda import block_attention_cuda
from megatron_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=300, seq_length=64)


def _cfgs(name, **kw):
    if name == "gpt":
        return jconfig.gpt_config(**SMALL, **kw), tconfig.gpt_config(
            **SMALL, **kw)
    fn = {"llama": "llama2_config", "falcon": "falcon_config",
          "mixtral": "mixtral_config"}[name]
    return (getattr(jconfig, fn)("tiny", **SMALL, **kw),
            getattr(tconfig, fn)("tiny", **SMALL, **kw))


@pytest.mark.parametrize("name", ["llama", "falcon", "gpt", "mixtral"])
def test_params_from_numpy_keeps_tree_names_and_shapes(name):
    jcfg, tcfg = _cfgs(name)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    flat = _flatten(params)
    state = params_from_numpy(params, tcfg, device="cpu")
    assert sorted(state) == sorted(k.replace("/", ".") for k in flat)
    for key, arr in flat.items():
        t = state[key.replace("/", ".")]
        assert tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(t.numpy(), arr)
    # the model built on the meta device declares the same tree
    meta = LanguageModel(tcfg, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in meta.items()} == {
        k: tuple(v.shape) for k, v in state.items()}


def test_params_from_numpy_rejects_mismatch():
    jcfg, tcfg = _cfgs("llama")
    flat = _flatten(jlm.model_init(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError):
        params_from_numpy({**flat, "lm_head": flat["lm_head"][:, :8]}, tcfg,
                          device="cpu")
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in flat.items() if k != "lm_head"},
                          tcfg, device="cpu")


@pytest.mark.parametrize("name", ["llama", "gpt", "mixtral"])
def test_npz_checkpoint_loads_with_same_logits(tmp_path, name):
    jcfg, _ = _cfgs(name, compute_dtype="float32")
    params = jlm.model_init(jax.random.PRNGKey(1), jcfg)
    save_checkpoint(str(tmp_path), TrainState(params, None, jnp.int32(3)),
                    jconfig.MegatronConfig(model=jcfg), iteration=3,
                    backend="npz")
    model, cfg = load_npz_checkpoint(str(tmp_path), device="cpu")
    assert cfg.hidden_size == jcfg.hidden_size and cfg.num_layers == 2
    toks = np.random.RandomState(0).randint(0, 300, (2, 16))
    want, _ = jlm.model_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, _ = model_forward(model, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor transformers, safetensors, tokenizers, sentencepiece or regex:
    the weight toolchain reads and writes HF directories itself, and the
    tokenizers read tokenizer.json and split GPT-2's pattern on the
    standard library."""
    files = sorted((ROOT / "megatron_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ("serving/engine.py", "serving/kv_pool.py",
                   "serving/request.py", "serving/scheduler.py",
                   "serving/metrics.py", "serving/__init__.py",
                   "ops/block_attention.py", "ops/block_attention_cuda.py",
                   "ops/cuda_build.py", "ops/fused_norms.py",
                   "ops/fused_norms_cuda.py", "ops/quantized.py",
                   "tools/bench_kernels.py", "tools/bench_decode.py",
                   "convert/hf.py", "convert/hf_io.py", "convert/meta.py",
                   "convert/megatron.py", "verify_correctness.py",
                   "tools/convert_hf_checkpoint.py",
                   "tools/run_text_generation_server.py",
                   "tools/text_generation_cli.py", "tools/merge_datasets.py",
                   "tools/compare_loss_curves.py",
                   "tools/validate_dataset.py", "data/hf_tokenizer.py",
                   "data/tokenizers.py", "resilience/faults.py",
                   "resilience/watchdog.py", "serving/prefix_index.py",
                   "serving/spec_decode.py", "serving/host_tier.py",
                   "serving/router.py", "tools/chaos_common.py",
                   "tools/chaos_router.py", "serving/remote.py",
                   "tools/chaos_fleet.py", "tools/serving_bench.py",
                   "models/moe.py", *PRETRAINING, *RETRIEVAL, *ZERO_SHOT,
                   *MESH):
        assert f"megatron_tpu_torch/{module}" in names, module
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "megatron_tpu", "flax",
                               "optax", "orbax", "transformers",
                               "safetensors", "tokenizers", "sentencepiece",
                               "regex", "requests", "tasks"), \
                f"{path}: imports {mod}"


# the BERT and T5 pretraining slice
PRETRAINING = ("ops/dropout.py", "models/bert.py", "models/t5.py",
               "data/masked_dataset.py", "training/pretrain.py",
               "pretrain_bert.py", "pretrain_t5.py")

# the BERT heads and the retriever slice
RETRIEVAL = ("data/ict_dataset.py", "data/orqa_dataset.py",
             "data/realm_index.py", "models/classification.py",
             "models/biencoder.py", "indexer.py", "pretrain_ict.py",
             "tools/create_doc_index.py", "tasks/main.py",
             "tasks/data_utils.py", "tasks/finetune_utils.py",
             "tasks/glue/data.py", "tasks/race/data.py",
             "tasks/orqa/data.py", "tasks/orqa/evaluate.py",
             "tasks/orqa/finetune.py", "tasks/orqa/qa_utils.py")

# zero-shot evaluation, MSDP, length buckets and the engine bench tools
ZERO_SHOT = ("tasks/zeroshot_gpt/detokenizer.py",
             "tasks/zeroshot_gpt/datasets.py",
             "tasks/zeroshot_gpt/evaluate.py", "tasks/msdp/metrics.py",
             "tasks/msdp/evaluate.py", "tasks/msdp/prompt.py",
             "tasks/msdp/preprocessing.py", "tasks/msdp/main.py",
             "data/buckets.py", "tools/bench_common.py",
             "tools/bench_block_attn.py", "tools/bench_spec.py",
             "tools/bench_prefix.py", "tools/bench_sync.py")

# the mesh: tensor and sequence parallelism, data parallelism and ZeRO-1,
# and the pipeline with its two tools
MESH = ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
        "parallel/collectives.py", "parallel/sharding.py",
        "parallel/ring_attention.py", "parallel/ulysses.py",
        "parallel/pipeline.py", "training/train_step.py",
        "training/optimizer.py", "training/checkpointing.py",
        "training/loop.py", "training/pretrain.py", "finetune.py",
        "arguments.py", "tools/bench_bubble.py", "tools/bench_head.py")

FRONT_DOOR = ("serving/host_tier.py", "serving/router.py",
              "serving/request.py", "serving/metrics.py",
              "inference/server.py", "tools/chaos_common.py",
              "tools/chaos_router.py",
              "tools/run_text_generation_server.py", "serving/remote.py",
              "tools/chaos_fleet.py", "tools/serving_bench.py")


@pytest.mark.parametrize("module", FRONT_DOOR)
def test_front_door_modules_import_no_jax(module):
    """The front door's modules, imported in a fresh interpreter, load
    neither jax nor the JAX package (directly or through what they
    import)."""
    _assert_imports_no_jax(module)


@pytest.mark.parametrize("module", PRETRAINING)
def test_pretraining_modules_import_no_jax(module):
    """The same for the BERT and T5 pretraining slice's modules."""
    _assert_imports_no_jax(module)


@pytest.mark.parametrize("module", RETRIEVAL)
def test_retrieval_modules_import_no_jax(module):
    """The same for the BERT heads and the retriever slice's modules, the
    root `tasks` package included."""
    _assert_imports_no_jax(module)


@pytest.mark.parametrize("module", ZERO_SHOT)
def test_zero_shot_msdp_bench_modules_import_no_jax(module):
    """The same for the zero-shot, MSDP, buckets and bench tools slice's
    modules (nor `requests`: the card's machine has none)."""
    _assert_imports_no_jax(module)


@pytest.mark.parametrize("module", MESH)
def test_mesh_modules_import_no_jax(module):
    """The same for the mesh slice's modules and the training modules it
    changed."""
    _assert_imports_no_jax(module)


def _assert_imports_no_jax(module):
    import subprocess
    import sys
    name = "megatron_tpu_torch." + module[:-3].replace("/", ".")
    code = (f"import sys, {name}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'megatron_tpu', 'tasks', 'requests')); "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_gpu_and_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("llama")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageModel(tcfg)
    model = LanguageModel(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(model, tcfg, eos_id=0)
    gen = Generator(model, tcfg, eos_id=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MegatronServer(gen, tokenizer=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(gen, ServingConfig(num_slots=1, max_len=64))
    MegatronServer(gen, tokenizer=None, device="cpu").close()
    ServingEngine(gen, ServingConfig(num_slots=1, max_len=64),
                  device="cpu").close()


def test_block_attention_launches_the_kernel_or_raises():
    """A CUDA tensor never reaches the plain version: without a card the
    kernel's wrapper refuses it rather than fall back."""
    q = torch.zeros(1, 1, 4, 64)
    arena = torch.zeros(3, 16, 4, 64)
    bmap = torch.zeros(1, 2, dtype=torch.int32)
    lengths = torch.zeros(1, dtype=torch.int32)
    out = block_native_attention(q, arena, arena, bmap, lengths, scale=0.1,
                                 block_size=16)
    assert out.shape == q.shape
    before = block_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        block_attention_cuda(q, arena, arena, bmap, lengths, scale=0.1,
                             block_size=16)
    assert block_attention_cuda.launches == before
