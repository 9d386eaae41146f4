"""Multi-stage dialogue prompting (MSDP) entry point (tasks/msdp/main.py).

  python -m megatron_tpu_torch.tasks.msdp.main --task MSDP-PROMPT \
      --prompt_type knowledge --prompt_file knwl_prompts.jsonl \
      --sample_input_file test.txt --sample_output_file knwl_out.txt \
      --load <ckpt> --tokenizer_type GPT2BPETokenizer \
      --vocab_file vocab.json --merge_file merges.txt
  python -m megatron_tpu_torch.tasks.msdp.main --task MSDP-EVAL-F1 \
      --guess_file out.txt --answer_file gold.txt

MSDP-PROMPT generates on the current CUDA device (`main(argv,
device="cpu")` on the CPU; without a GPU and a `device` it raises), or
through a running server with --megatron_api_url.
"""
from __future__ import annotations

import argparse
import sys

from megatron_tpu_torch.utils.device import DeviceLike


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("msdp", description=__doc__.splitlines()[0])
    p.add_argument("--task", required=True,
                   choices=["MSDP-PROMPT", "MSDP-EVAL-F1"])
    # prompting
    p.add_argument("--sample_input_file", default=None)
    p.add_argument("--sample_output_file", default=None)
    p.add_argument("--prompt_file", default=None)
    p.add_argument("--prompt_type", default=None,
                   choices=["knowledge", "response"])
    p.add_argument("--num_prompt_examples", type=int, default=10)
    p.add_argument("--out_seq_length", type=int, default=100)
    p.add_argument("--megatron_api_url", default=None,
                   help="generate through a running text-generation server "
                        "(host:port/api) instead of loading the model")
    p.add_argument("--load", default=None)
    p.add_argument("--tokenizer_type", default="GPT2BPETokenizer")
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merge_file", default=None)
    # evaluation
    p.add_argument("--guess_file", default=None)
    p.add_argument("--answer_file", default=None)
    return p


def main(argv=None, *, device: DeviceLike = None) -> int:
    args = get_parser().parse_args(argv)
    if args.task == "MSDP-PROMPT":
        if not (args.sample_input_file and args.prompt_file):
            raise SystemExit("MSDP-PROMPT needs --sample_input_file and "
                             "--prompt_file")
        from megatron_tpu_torch.tasks.msdp.prompt import run_prompting
        return run_prompting(args, device)
    if not (args.guess_file and args.answer_file):
        raise SystemExit("MSDP-EVAL-F1 needs --guess_file and --answer_file")
    from megatron_tpu_torch.tasks.msdp.evaluate import evaluate_f1
    evaluate_f1(args.guess_file, args.answer_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
