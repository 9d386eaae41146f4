"""Text generation API: tokenize -> generate -> detokenize
(megatron_tpu/inference/api.py)."""
from __future__ import annotations

from typing import Optional, Sequence

from megatron_tpu_torch.inference.generation import (Generator,
                                                     SamplingParams,
                                                     beam_search)


def generate_and_post_process(
    generator: Generator,
    tokenizer,
    prompts: Sequence[str],
    tokens_to_generate: int = 64,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    add_BOS: bool = False,
    return_output_log_probs: bool = False,
    seed: int = 0,
    prompt_ids: Optional[Sequence[Sequence[int]]] = None,
):
    """Returns (texts, tokens, logprobs | None). `prompt_ids`: prompts
    already tokenized (BOS applied), so a validating caller tokenizes once."""
    if prompt_ids is None:
        prompt_ids = []
        for p in prompts:
            ids = tokenizer.tokenize(p)
            if add_BOS and tokenizer.bos is not None:
                ids = [tokenizer.bos] + ids
            prompt_ids.append(ids)
    sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p)
    tokens, lengths, logprobs = generator.generate(
        prompt_ids, tokens_to_generate, sampling=sp, seed=seed)
    out_tokens = [tokens[i, :lengths[i]].tolist() for i in range(len(prompts))]
    texts = [tokenizer.detokenize(t) for t in out_tokens]
    if return_output_log_probs:
        lps = [logprobs[i, :lengths[i]].tolist() for i in range(len(prompts))]
        return texts, out_tokens, lps
    return texts, out_tokens, None


def beam_search_and_post_process(
    generator: Generator,
    tokenizer,
    prompt: str,
    tokens_to_generate: int = 64,
    beam_size: int = 4,
    length_penalty: float = 1.0,
    add_BOS: bool = False,
    prompt_ids: Optional[Sequence[int]] = None,
):
    """Returns (texts, scores), best beam first."""
    if prompt_ids is not None:
        ids = list(prompt_ids)
    else:
        ids = tokenizer.tokenize(prompt)
        if add_BOS and tokenizer.bos is not None:
            ids = [tokenizer.bos] + ids
    tokens, lengths, scores = beam_search(
        generator, ids, beam_size, tokens_to_generate,
        length_penalty=length_penalty)
    texts = [tokenizer.detokenize(tokens[i, :lengths[i]].tolist())
             for i in range(len(tokens))]
    return texts, scores.tolist()
