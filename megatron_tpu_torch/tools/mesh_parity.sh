#!/usr/bin/env bash
# The sharded trainer over NCCL on four GPUs of one host against one GPU,
# through the finetune entry point: Llama-2-7B's width at 2 layers, fp32
# (the flag-built model), seq 4096, a global batch of 4 in microbatches of
# 2 rows, 3 iterations on a synthetic corpus made from a seed. It trains
# on one GPU, then (dp 2 x tp 2, sequence parallel, ZeRO-1) and (tp 4,
# sequence parallel) under torchrun; each run's log lands in OUT_DIR
# (default build/mesh_parity) and its iteration lines (lm loss, grad norm, ms,
# tokens/s) and memory line are printed, to be read side by side.
#
#   megatron_tpu_torch/tools/mesh_parity.sh [OUT_DIR]
set -euo pipefail
root="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${root}${PYTHONPATH:+:${PYTHONPATH}}"
out=${1:-build/mesh_parity}
mkdir -p "${out}"

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "from megatron_tpu_torch.ops import cuda_build; cuda_build.build()"
data=$(mktemp -d)
trap 'rm -rf "${data}"' EXIT
python -m megatron_tpu_torch.tools.synthetic_corpus --out "${data}" \
    --docs 300 --seed 0
python -m megatron_tpu_torch.tools.preprocess_data \
    --input "${data}/corpus.jsonl" --output_prefix "${data}/c" \
    --tokenizer_type GPT2BPETokenizer --vocab_file "${data}/vocab.json" \
    --merge_file "${data}/merges.txt" --append_eod > /dev/null
args=(--num_layers 2 --hidden_size 4096 --num_attention_heads 32
      --ffn_hidden_size 11008 --seq_length 4096 --use_rms_norm
      --glu_activation swiglu --use_flash_attn --global_batch_size 4
      --train_iters 3 --log_interval 1 --eval_interval 1000 --lr 3e-5
      --data_path "${data}/c_document" --split 100,0,0
      --tokenizer_type GPT2BPETokenizer --vocab_file "${data}/vocab.json"
      --merge_file "${data}/merges.txt")
show() { grep "iteration\|memory\|mesh" "$1"; }

echo "=== one GPU"
python -m megatron_tpu_torch.finetune "${args[@]}" --micro_batch_size 2 \
    > "${out}/mesh_parity_one.log" 2>&1
show "${out}/mesh_parity_one.log"
echo "=== 4 GPUs: dp 2 x tp 2, sequence parallel, ZeRO-1"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${args[@]}" --micro_batch_size 1 --tensor_model_parallel_size 2 \
    --sequence_parallel --use_distributed_optimizer \
    > "${out}/mesh_parity_dp2tp2.log" 2>&1
show "${out}/mesh_parity_dp2tp2.log"
echo "=== 4 GPUs: tp 4, sequence parallel"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${args[@]}" --micro_batch_size 2 --tensor_model_parallel_size 4 \
    --sequence_parallel > "${out}/mesh_parity_tp4.log" 2>&1
show "${out}/mesh_parity_tp4.log"
