"""Multi-stage dialogue prompting: knowledge and response generation
(tasks/msdp/prompt.py).

Few-shot prompts and the dialogue context go to a pretrained GPT model (an
in-process `Generator` or a running text-generation server), one greedy
generation a test sample, the first line kept.

Test file format (WoW/WoI, preprocessed): TAB-separated
`topic\\tdialogue turns ([SEP]-joined)[\\tknowledge]` a line. Knowledge
prompts file: JSON lines {"<topic> <last turn>": [example, ...]}; response
prompts file: plain text, one example a line.
"""
from __future__ import annotations

import json
import re
import urllib.request
from typing import Callable, Dict, List

from megatron_tpu_torch.utils.device import DeviceLike


def _simple_word_tokenize(text: str) -> List[str]:
    """Words and single punctuation marks: the splitter that stands in for
    nltk.word_tokenize in the response prompts."""
    return re.findall(r"\w+|[^\w\s]", text, re.UNICODE)


def read_prompts(prompt_path: str, prompt_type: str, n_example: int):
    """Knowledge prompts: a dict of few-shot strings by key; response
    prompts: one fixed few-shot string."""
    if prompt_type == "knowledge":
        prompt_dict: Dict[str, str] = {}
        with open(prompt_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                (key, examples), = d.items()
                if key not in prompt_dict:
                    prompt_dict[key] = "".join(
                        ex.strip() + " \n" for ex in examples[:n_example])
        return prompt_dict
    with open(prompt_path, encoding="utf-8") as f:
        examples = f.readlines()[:n_example]
    return "".join(ex.strip() + " \n" for ex in examples)


def build_input(test_line: str, prompt_type: str, prompts) -> str:
    """One test row -> the model's input: knowledge mode appends
    `( last_turn ) topic =>`; response mode appends the
    Topic/User-says/We-know-that/System-replies template."""
    splits = test_line.strip().split("\t")
    topic = splits[0]
    turns = splits[1].split(" [SEP] ")
    last_turn = turns[-1]
    if prompt_type == "knowledge":
        key = topic + " " + last_turn
        base = prompts[key]
        return base + "( " + last_turn + " ) " + topic + " =>"
    knowledge = " ".join(_simple_word_tokenize(splits[2])).strip()
    last = " ".join(_simple_word_tokenize(last_turn)).strip()
    return (prompts + "Topic: " + topic + ". "
            + "User says: " + last + " "
            + "We know that: " + knowledge + " "
            + "System replies:")


def _first_line(generation: str, input_text: str) -> str:
    """Strip the echoed prompt, keep the first generated line."""
    out = generation[len(input_text):] if \
        generation.startswith(input_text) else generation
    return out.split("\n")[0].strip()


def generate_samples(test_lines: List[str], *, prompt_type: str,
                     prompts, generate_fn: Callable[[str, int], str],
                     out_seq_length: int = 100,
                     log_interval: int = 20) -> List[str]:
    """Prompt the model once a test sample.
    `generate_fn(input_text, max_new_tokens) -> full generation text`."""
    if prompt_type not in ("knowledge", "response"):
        raise ValueError("Please input a correct prompt type!")
    outputs = []
    for i, line in enumerate(test_lines):
        if not line.strip():
            # keep the lines aligned with the golden answer file (F1 pairs
            # guesses and answers by line number)
            outputs.append("")
            continue
        inputs = build_input(line, prompt_type, prompts)
        generation = generate_fn(inputs, out_seq_length)
        outputs.append(_first_line(generation, inputs))
        if log_interval and (i + 1) % log_interval == 0:
            print(f"msdp: generated {i + 1}/{len(test_lines)}", flush=True)
    return outputs


def make_generator_fn(generator, tokenizer) -> Callable[[str, int], str]:
    """In-process greedy generation (top_k 1). The prompt is stripped at the
    token boundary and the input text put back in front, so that a lossy
    tokenizer round trip leaves no prompt fragment in the output and
    `_first_line` treats both paths alike."""
    from megatron_tpu_torch.inference.generation import SamplingParams

    def fn(text: str, max_new: int) -> str:
        prompt_ids = tokenizer.tokenize(text)
        tokens, lengths, _ = generator.generate(
            [prompt_ids], max_new, sampling=SamplingParams(top_k=1))
        new_ids = tokens[0, len(prompt_ids):lengths[0]].tolist()
        return text + tokenizer.detokenize(new_ids)

    return fn


def api_url(url: str) -> str:
    """`host:port/api` as `http://host:port/api`: a URL without a scheme
    (the examples pass one) gets http://, as the text-generation CLI's
    does."""
    return url if "://" in url else "http://" + url


def make_api_fn(url: str, timeout: float = 600.0
                ) -> Callable[[str, int], str]:
    """Generation through a running server's PUT /api (greedy, top_k 1),
    on the standard library."""
    url = api_url(url)

    def fn(text: str, max_new: int) -> str:
        req = urllib.request.Request(
            url, method="PUT",
            headers={"Content-Type": "application/json; charset=UTF-8"},
            data=json.dumps({"prompts": [text],
                             "tokens_to_generate": max_new,
                             "top_k": 1}).encode())
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())["text"][0]

    return fn


def run_prompting(args, device: DeviceLike = None) -> int:
    """The MSDP-PROMPT body: generate for every line of
    --sample_input_file, write the first lines to --sample_output_file."""
    with open(args.sample_input_file, encoding="utf-8") as f:
        test_lines = f.readlines()
    prompts = read_prompts(args.prompt_file, args.prompt_type,
                           args.num_prompt_examples)

    if args.megatron_api_url:
        generate_fn = make_api_fn(args.megatron_api_url)
    else:
        from megatron_tpu_torch.convert.from_jax import load_npz_checkpoint
        from megatron_tpu_torch.data.tokenizers import build_tokenizer
        from megatron_tpu_torch.inference.generation import Generator

        if not args.load:
            raise SystemExit("MSDP-PROMPT needs --load or "
                             "--megatron_api_url")
        tokenizer = build_tokenizer(
            args.tokenizer_type, vocab_file=args.vocab_file,
            merge_file=args.merge_file, tokenizer_model=args.tokenizer_model)
        model, cfg = load_npz_checkpoint(args.load, device)
        eos = tokenizer.eod if tokenizer.eod is not None else 0
        generator = Generator(model, cfg, eos, device=device)
        generate_fn = make_generator_fn(generator, tokenizer)

    outputs = generate_samples(
        test_lines, prompt_type=args.prompt_type, prompts=prompts,
        generate_fn=generate_fn, out_seq_length=args.out_seq_length)
    out_path = args.sample_output_file or args.sample_input_file + ".out"
    with open(out_path, "w", encoding="utf-8") as f:
        for line in outputs:
            f.write(line + "\n")
    print(f"msdp: wrote {len(outputs)} generations -> {out_path}")
    return 0
