#!/usr/bin/env bash
# Tokenize a train/valid pair of loose-JSON corpora into the indexed
# .bin/.idx format with the port's preprocess_data (the port of the root
# tools/tokenize_corpus.sh: the same arguments, the same output files).
#
#   megatron_tpu_torch/tools/tokenize_corpus.sh TRAIN.jsonl VALID.jsonl \
#       OUT_PREFIX [TOKENIZER_TYPE] [TOKENIZER_MODEL_OR_VOCAB...]
#
# The default tokenizer is HFTokenizer, as in the reference's Falcon
# example; WORKERS (default 2) sets preprocess_data's --workers.
set -euo pipefail
# no cd: the caller's relative paths (corpora, vocab files, OUT_PREFIX)
# resolve from the caller's directory; the package is found through
# PYTHONPATH from the script's own location
root="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${root}${PYTHONPATH:+:${PYTHONPATH}}"

train=${1:?usage: tokenize_corpus.sh TRAIN.jsonl VALID.jsonl OUT_PREFIX [type] [model...]}
valid=${2:?need VALID.jsonl}
prefix=${3:?need OUT_PREFIX}
ttype=${4:-HFTokenizer}
shift $(( $# > 4 ? 4 : $# ))

echo "Tokenizing ${train} -> ${prefix}-train"
python -m megatron_tpu_torch.tools.preprocess_data --input "${train}" \
    --output_prefix "${prefix}-train" --tokenizer_type "${ttype}" \
    --workers "${WORKERS:-2}" --append_eod "$@"

echo "Tokenizing ${valid} -> ${prefix}-valid"
python -m megatron_tpu_torch.tools.preprocess_data --input "${valid}" \
    --output_prefix "${prefix}-valid" --tokenizer_type "${ttype}" \
    --workers "${WORKERS:-2}" --append_eod "$@"
