#!/usr/bin/env bash
# The sharded trainer over NCCL on four GPUs of one host against one GPU,
# through the finetune entry point, fp32 (the flag-built models), seq 4096,
# a global batch of 4 in microbatches of 2 rows (1 where dp is 2 with
# experts on dp), 3 iterations on a synthetic corpus made from a seed.
# Llama-2-7B's width at 2 layers trains on one GPU, then under torchrun at
# (dp 2 x tp 2, sequence parallel, ZeRO-1), (tp 4, sequence parallel),
# (cp 2 x tp 2, sequence parallel, ring attention) and (cp 4, Ulysses).
# Mixtral-8x7B's width (32/8 heads, ffn 14336, 8 experts, top 2, capacity
# 1.25) at 1 layer trains on one GPU, then at (tp 2 x dp 2, experts on tp,
# sequence parallel) and (dp 2 x tp 2, experts on dp, ZeRO-1). Each run's
# log lands in OUT_DIR (default build/mesh_parity) and its iteration lines
# (lm loss, grad norm, ms, tokens/s) and memory line are printed, to be
# read side by side.
# The pipeline part: Llama-2-7B's width at 4 layers trains on one GPU, then
# at (pp 2 x tp 2, sequence parallel), (pp 4) and (pp 2 with 2 virtual
# chunks x dp 2), a global batch of 4 one-row microbatches (two a dp rank
# at dp 2); then tools/bench_bubble times the 1F1B step at pp 4 over
# n_micro 4-32, vpp 1 and 2.
# PARTS (default all) picks "mesh" (the runs above the pipeline's) or
# "pipeline".
#
#   megatron_tpu_torch/tools/mesh_parity.sh [OUT_DIR] [all|mesh|pipeline]
set -euo pipefail
root="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${root}${PYTHONPATH:+:${PYTHONPATH}}"
out=${1:-build/mesh_parity}
parts=${2:-all}
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
common=(--seq_length 4096 --use_rms_norm --glu_activation swiglu
        --use_flash_attn --global_batch_size 4 --train_iters 3
        --log_interval 1 --eval_interval 1000 --lr 3e-5
        --data_path "${data}/c_document" --split 100,0,0
        --tokenizer_type GPT2BPETokenizer --vocab_file "${data}/vocab.json"
        --merge_file "${data}/merges.txt")
args=(--num_layers 2 --hidden_size 4096 --num_attention_heads 32
      --ffn_hidden_size 11008 "${common[@]}")
moe=(--num_layers 1 --hidden_size 4096 --num_attention_heads 32
     --num_attention_heads_kv 8 --ffn_hidden_size 14336 --num_experts 8
     --moe_top_k 2 "${common[@]}")
show() { grep "iteration\|memory\|mesh" "$1"; }

if [[ "${parts}" != "pipeline" ]]; then
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
echo "=== 4 GPUs: cp 2 x tp 2, sequence parallel, ring attention"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${args[@]}" --micro_batch_size 2 --context_parallel_size 2 \
    --tensor_model_parallel_size 2 --sequence_parallel \
    > "${out}/mesh_parity_cp2tp2_ring.log" 2>&1
show "${out}/mesh_parity_cp2tp2_ring.log"
echo "=== 4 GPUs: cp 4, Ulysses"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${args[@]}" --micro_batch_size 2 --context_parallel_size 4 \
    --context_parallel_algo ulysses > "${out}/mesh_parity_cp4_ulysses.log" 2>&1
show "${out}/mesh_parity_cp4_ulysses.log"

echo "=== Mixtral, one GPU"
python -m megatron_tpu_torch.finetune "${moe[@]}" --micro_batch_size 2 \
    > "${out}/mesh_parity_moe_one.log" 2>&1
show "${out}/mesh_parity_moe_one.log"
echo "=== Mixtral, 4 GPUs: tp 2 x dp 2, experts on tp, sequence parallel"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${moe[@]}" --micro_batch_size 1 --tensor_model_parallel_size 2 \
    --sequence_parallel > "${out}/mesh_parity_moe_tp2.log" 2>&1
show "${out}/mesh_parity_moe_tp2.log"
echo "=== Mixtral, 4 GPUs: dp 2 x tp 2, experts on dp, ZeRO-1"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${moe[@]}" --micro_batch_size 1 --tensor_model_parallel_size 2 \
    --expert_axis dp --use_distributed_optimizer \
    > "${out}/mesh_parity_moe_dp2.log" 2>&1
show "${out}/mesh_parity_moe_dp2.log"
fi

if [[ "${parts}" != "mesh" ]]; then
pipe=(--num_layers 4 --hidden_size 4096 --num_attention_heads 32
      --ffn_hidden_size 11008 --micro_batch_size 1 "${common[@]}")
echo "=== pipeline: one GPU, 4 layers"
python -m megatron_tpu_torch.finetune "${pipe[@]}" \
    > "${out}/mesh_parity_pp_one.log" 2>&1
show "${out}/mesh_parity_pp_one.log"
echo "=== 4 GPUs: pp 2 x tp 2, sequence parallel"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${pipe[@]}" --pipeline_model_parallel_size 2 \
    --tensor_model_parallel_size 2 --sequence_parallel \
    > "${out}/mesh_parity_pp2tp2.log" 2>&1
show "${out}/mesh_parity_pp2tp2.log"
echo "=== 4 GPUs: pp 4"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${pipe[@]}" --pipeline_model_parallel_size 4 \
    > "${out}/mesh_parity_pp4.log" 2>&1
show "${out}/mesh_parity_pp4.log"
echo "=== 4 GPUs: pp 2, vpp 2 x dp 2"
torchrun --standalone --nproc_per_node 4 -m megatron_tpu_torch.finetune \
    "${pipe[@]}" --pipeline_model_parallel_size 2 \
    --num_layers_per_virtual_pipeline_stage 1 \
    > "${out}/mesh_parity_pp2vpp2dp2.log" 2>&1
show "${out}/mesh_parity_pp2vpp2dp2.log"
echo "=== 4 GPUs: bench_bubble at pp 4"
torchrun --standalone --nproc_per_node 4 \
    -m megatron_tpu_torch.tools.bench_bubble --n_micro 4 8 16 32 \
    --vpp 1 2 --out "${out}/bench_bubble_pp4.log" \
    > "${out}/bench_bubble_pp4.stdout" 2>&1
grep "bubble" "${out}/bench_bubble_pp4.log"
fi
