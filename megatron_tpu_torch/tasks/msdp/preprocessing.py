"""MSDP data preparation for Wizard-of-Wikipedia and Wizard-of-Internet
(tasks/msdp/preprocessing.py), the same file contracts in five stages:

1. process_wow_dataset / process_woi_dataset: raw dialogue dumps ->
   4-column TSV ``topic \\t context \\t knowledge \\t response`` (turns
   joined by " [SEP] "), plus optional knowledge/response reference files
   for the F1 evaluators.
2. prompt_selection_for_knowledge_generation: 10 few-shot prompts a test
   sample by dense similarity between the test dialogue and the training
   dialogues. Any ``encode_fn(list[str]) -> [n, d] array`` works; the
   default is `biencoder_encode_fn`, the query tower of a biencoder
   checkpoint (models/biencoder.py) on the card.
3. prompt_selection_for_response_generation: training rows filtered by
   their knowledge->response token overlap, 20 drawn.
4. prepare_input_for_response_generation: the generated knowledge spliced
   back into the test TSV for the response pass.

Words are split as tasks/msdp/prompt.py splits them (the evaluation
normalizes again in metrics.py).
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional

import numpy as np

from megatron_tpu_torch.tasks.msdp.prompt import _simple_word_tokenize
from megatron_tpu_torch.utils.device import DeviceLike

SEP = " [SEP] "
NO_KNOWLEDGE = "no_passages_used"


def _end_punctuate(text: str) -> str:
    return text if text.endswith(("?", ".", "!")) else text + "."


def _sanitize(text: str) -> str:
    # a tab or newline inside raw dialogue text would corrupt the 4-column
    # TSV and misalign every following reference-file line
    return text.replace("\n", "").replace("\r", "").replace("\t", "")


def _tok_join(text: str) -> str:
    return " ".join(_simple_word_tokenize(text))


def _write_row(fproc, fknwl, fresp, topic, context, knowledge, response):
    fproc.write(f"{topic}\t{context}\t{knowledge}\t{response}\n")
    if fknwl is not None:
        fknwl.write(knowledge + "\n")
    if fresp is not None:
        # tokenized for the F1 evaluator (metrics.py re-normalizes)
        fresp.write(_tok_join(response) + "\n")


def process_wow_dataset(raw_file: str, processed_file: str,
                        knwl_ref_file: Optional[str] = None,
                        resp_ref_file: Optional[str] = None) -> int:
    """Wizard-of-Wikipedia JSON dump -> 4-column TSV; returns row count.

    One output row per wizard turn: the wizard's checked sentence is the
    golden knowledge, the checked passage (falling back to the chosen
    topic) is the topic, and everything said so far is the context."""
    with open(raw_file) as f:
        dialogues = json.load(f)
    n = 0
    fknwl = open(knwl_ref_file, "w") if knwl_ref_file else None
    fresp = open(resp_ref_file, "w") if resp_ref_file else None
    with open(processed_file, "w") as fproc:
        for sample in dialogues:
            history: List[str] = []
            for i, turn in enumerate(sample["dialog"]):
                text = _end_punctuate(turn["text"])
                if i == 0:
                    history.append(text)
                    continue
                if "wizard" not in turn["speaker"].lower():
                    history.append(text)
                    continue
                sentences = list(turn["checked_sentence"].values())
                passages = list(turn["checked_passage"].values())
                knowledge = sentences[0] if sentences else NO_KNOWLEDGE
                passage = passages[0] if len(passages) == 1 else NO_KNOWLEDGE
                topic = (passage if passage != NO_KNOWLEDGE
                         else sample["chosen_topic"])
                _write_row(fproc, fknwl, fresp, topic, SEP.join(history),
                           knowledge, text)
                history.append(text)
                n += 1
    for f in (fknwl, fresp):
        if f is not None:
            f.close()
    return n


def process_woi_dataset(raw_file: str, processed_file: str,
                        knwl_ref_file: Optional[str] = None,
                        resp_ref_file: Optional[str] = None) -> int:
    """Wizard-of-Internet JSONL dump -> 4-column TSV; returns row count.

    The wizard's last search query becomes the topic and the first
    selected retrieved sentence the knowledge. WoI text is NOT
    end-punctuated (only WoW is), every field is stripped of \\t/\\n/\\r,
    and turns whose topic resolves to ``no_topic`` are dropped from all
    three output files (they still extend the dialogue history)."""
    n = 0
    fknwl = open(knwl_ref_file, "w") if knwl_ref_file else None
    fresp = open(resp_ref_file, "w") if resp_ref_file else None
    with open(raw_file) as fr, open(processed_file, "w") as fproc:
        for line in fr:
            line = line.strip()
            if not line:
                continue
            (record,) = json.loads(line).values()
            history: List[str] = []
            search_text = ""
            for item in record["dialog_history"]:
                action = item["action"]
                if action == "Wizard => SearchAgent":
                    search_text = item["text"]
                elif action == "Wizard => Apprentice":
                    if not history:
                        history.append(item["text"])
                        continue
                    knowledge = ""
                    ctx = item.get("context", {})
                    contents = ctx.get("contents", [])
                    selected = ctx.get("selected_contents", [])
                    no_select = bool(selected and selected[0] and
                                     selected[0][0])
                    if not no_select:
                        for content, sel in zip(contents, selected[1:]):
                            for sentence, s in zip(content["content"], sel):
                                if s:
                                    knowledge = sentence
                                    break
                            if knowledge:
                                break
                    if knowledge:
                        topic = search_text
                    else:
                        topic, knowledge = "no_topic", NO_KNOWLEDGE
                    response = _sanitize(item["text"])
                    if topic != "no_topic":
                        fproc.write(f"{_sanitize(topic)}\t"
                                    f"{_sanitize(SEP.join(history))}\t"
                                    f"{_sanitize(knowledge)}\t{response}\n")
                        if fknwl is not None:
                            fknwl.write(_sanitize(knowledge) + "\n")
                        if fresp is not None:
                            # tokenized for the F1 evaluator; `response`
                            # is reassigned here, so when (and only when) a
                            # response reference file is requested, the
                            # tokenized form enters the history below:
                            # later rows' contexts depend on this optional
                            # argument, as in the reference
                            response = _tok_join(response)
                            fresp.write(response + "\n")
                        n += 1
                    history.append(response)
                elif action == "Apprentice => Wizard":
                    history.append(item["text"])
    for f in (fknwl, fresp):
        if f is not None:
            f.close()
    return n


def _read_tsv(path: str):
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                yield line.split("\t")


def _query_sentence(topic: str, turns: List[str], data_type: str) -> str:
    prefix = "" if data_type == "wow_seen" else f"( {topic} ) "
    return prefix + " ".join(turns)


def get_database(test_datapath: str, train_datapath: str, data_type: str):
    """Index the training TSV for prompt selection.

    Returns (train_by_topic, dialogs_by_topic, examples) where examples is
    a list of (topic, dialog_example, prompt_instance) and the by-topic
    dicts cover topics that also appear in the test set. Filtering follows
    the reference: drop no-knowledge rows; for unseen/woi data drop rows
    whose knowledge has brackets or does not mention the topic; for
    off-test topics additionally drop long (>20 token) knowledge and
    pronoun-initial knowledge."""
    if data_type not in ("wow_seen", "wow_unseen", "woi"):
        raise ValueError(f"data_type {data_type!r}")
    test_topics = {row[0] for row in _read_tsv(test_datapath)}

    train_by_topic: dict = {}
    dialogs_by_topic: dict = {}
    examples = []
    for row in _read_tsv(train_datapath):
        topic, context, knowledge, response = row[:4]
        turns = context.split(SEP)[-3:]
        if knowledge == NO_KNOWLEDGE:
            continue
        if data_type != "wow_seen":
            if "(" in knowledge or ")" in knowledge:
                continue
            if topic not in knowledge:
                continue
        instance = f"( {turns[-1]} ) {topic} => {knowledge}"
        dialog_example = _query_sentence(topic, turns, data_type)
        if topic in test_topics:
            train_by_topic.setdefault(topic, []).append(instance)
            dialogs_by_topic.setdefault(topic, []).append(dialog_example)
        else:
            if len(knowledge.split()) > 20:
                continue
            if knowledge.lower().startswith(("it ", "this ")):
                continue
        examples.append((topic, dialog_example, instance))
    return train_by_topic, dialogs_by_topic, examples


def biencoder_encode_fn(model_file: str, *, batch_size: int = 64,
                        seq_length: Optional[int] = None,
                        device: DeviceLike = None) -> Callable:
    """An encode_fn from a biencoder checkpoint: the query tower's
    embeddings of padded `[CLS] ... [SEP]` rows, `batch_size` rows a
    forward, on `device` (the current CUDA device when None). `seq_length`
    defaults to the checkpoint model's own: past its
    max_position_embeddings the position lookups would clamp silently."""
    import torch

    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.models.biencoder import (embed_text,
                                                     load_biencoder, towers)
    from megatron_tpu_torch.training.checkpointing import \
        load_config_from_checkpoint
    from megatron_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = load_config_from_checkpoint(model_file)
    if cfg is None:
        raise ValueError(f"no config in checkpoint {model_file}")
    if seq_length is None:
        seq_length = cfg.model.seq_length
    tokenizer = build_tokenizer(cfg.data.tokenizer_type,
                                vocab_file=cfg.data.vocab_file,
                                tokenizer_model=cfg.data.tokenizer_model)

    class _Args:  # the argparse surface load_biencoder reads
        load = model_file
        ict_head_size = None
        biencoder_shared_query_context_model = False
        num_layers = cfg.model.num_layers
        hidden_size = cfg.model.hidden_size
        num_attention_heads = cfg.model.num_attention_heads

    model, mcfg = load_biencoder(_Args, tokenizer.vocab_size, seq_length,
                                 device)
    query_tower, _ = towers(model)
    cls_id, sep_id, pad_id = tokenizer.cls, tokenizer.sep, tokenizer.pad

    @torch.inference_mode()
    def encode(texts: List[str]) -> np.ndarray:
        out = []
        for lo in range(0, len(texts), batch_size):
            chunk = texts[lo:lo + batch_size]
            ids = np.full((len(chunk), seq_length), pad_id, np.int64)
            mask = np.zeros((len(chunk), seq_length), np.int64)
            for i, t in enumerate(chunk):
                toks = [cls_id] + tokenizer.tokenize(t)[:seq_length - 2] \
                    + [sep_id]
                ids[i, :len(toks)] = toks
                mask[i, :len(toks)] = 1
            tokens = torch.from_numpy(ids).to(device)
            out.append(embed_text(
                query_tower, tokens, mcfg,
                padding_mask=torch.from_numpy(mask).to(device),
                tokentype_ids=torch.zeros_like(tokens)).cpu().numpy())
        return np.concatenate(out, axis=0)

    return encode


def prompt_selection_for_knowledge_generation(
        test_datapath: str, train_datapath: str, model_file: Optional[str],
        output_prompt_path: str, data_type: str,
        encode_fn: Optional[Callable] = None, n_prompts: int = 10,
        device: DeviceLike = None) -> int:
    """Per test sample, select `n_prompts` few-shot knowledge-generation
    prompts by dense dialogue similarity.

    Seen topics: rank that topic's own training dialogues against the
    query and take the top-k (most similar LAST, as the prompt order).
    Unseen topics: rank ALL training dialogues, keeping the most similar
    instance per distinct topic until n_prompts are collected."""
    if encode_fn is None:
        if not model_file:
            raise ValueError("need --model_file or an encode_fn")
        encode_fn = biencoder_encode_fn(model_file, device=device)

    train_by_topic, dialogs_by_topic, examples = get_database(
        test_datapath, train_datapath, data_type)
    all_dialogs = [e[1] for e in examples]
    all_embeds = encode_fn(all_dialogs) if all_dialogs else None
    topic_embeds: dict = {}

    # one batched encode for every test query up front (a forward of one
    # row at a time would waste the batched encoder)
    test_rows = list(_read_tsv(test_datapath))
    queries = []
    for row in test_rows:
        turns = row[1].split(SEP)[-3:]
        queries.append(_query_sentence(row[0], turns, data_type))
    query_embeds = encode_fn(queries) if queries else None

    n = 0
    with open(output_prompt_path, "w") as fout:
        for row, query_emb in zip(test_rows, query_embeds
                                  if query_embeds is not None else []):
            topic, context = row[0], row[1]
            turns = context.split(SEP)[-3:]
            if topic in train_by_topic:
                # seen topic: top-k within the topic's own examples
                if topic not in topic_embeds:
                    topic_embeds[topic] = encode_fn(dialogs_by_topic[topic])
                sims = topic_embeds[topic] @ query_emb
                k = min(n_prompts, len(sims))
                order = np.argsort(-sims)[:k][::-1]
                selected = [train_by_topic[topic][i] for i in order]
            elif all_embeds is None:
                selected = []  # empty training database
            else:
                # unseen topic: most similar instance per distinct topic
                sims = all_embeds @ query_emb
                selected, seen = [], set()
                for i in np.argsort(-sims):
                    t = examples[i][0]
                    if t in seen:
                        continue
                    seen.add(t)
                    selected.append(examples[i][2])
                    if len(selected) == n_prompts:
                        break
                selected = selected[::-1]  # most similar last
            key = f"{topic} {turns[-1]}"
            fout.write(json.dumps({key: selected}) + "\n")
            n += 1
    return n


def _overlap_token_count(knowledge_tokens: List[str],
                         response_tokens: List[str],
                         min_run: int = 10) -> int:
    """Tokens of the response inside runs (>= min_run consecutive hits) of
    knowledge-vocabulary tokens — the copy-span detector the reference
    uses to find responses that quote their knowledge."""
    vocab = set(knowledge_tokens)
    total = run = 0
    for tok in response_tokens:
        if tok in vocab:
            run += 1
        else:
            if run >= min_run:
                total += run
            run = 0
    if run >= min_run:
        total += run
    return total


def prompt_selection_for_response_generation(
        input_path: str, output_path: str, seed: int = 1234,
        n_prompts: int = 20) -> int:
    """Pick response-generation prompts: rows whose response quotes its
    knowledge at a 60-90% overlap ratio (and covers >= 80% of the
    knowledge), shuffled, first `n_prompts`."""
    rng = np.random.default_rng(seed)
    candidates = []
    for row in _read_tsv(input_path):
        topic, context, knowledge, response = row[:4]
        if knowledge == NO_KNOWLEDGE:
            continue
        k_toks = _simple_word_tokenize(knowledge)
        r_toks = _simple_word_tokenize(response)
        overlap = _overlap_token_count(k_toks, r_toks)
        if not (0.6 * len(r_toks) <= overlap <= 0.9 * len(r_toks)):
            continue
        if overlap < 0.8 * len(k_toks):
            continue
        last = _tok_join(context.split(SEP)[-1])
        candidates.append(
            f"Topic: {topic}. User says: {last} "
            f"We know that: {' '.join(k_toks)} "
            f"System replies: {' '.join(r_toks)}")
    rng.shuffle(candidates)
    chosen = candidates[:n_prompts]
    with open(output_path, "w") as f:
        for line in chosen:
            f.write(line + "\n")
    return len(chosen)


def prepare_input_for_response_generation(test_file: str,
                                          knwl_gen_file: str,
                                          processed_file: str) -> int:
    """Splice the GENERATED knowledge (one line per test row) back into
    the test TSV in place of the golden knowledge."""
    with open(knwl_gen_file) as f:
        knowledge = [line.strip().replace("<|endoftext|>", "")
                     for line in f]
    rows = list(_read_tsv(test_file))
    if len(knowledge) != len(rows):
        raise ValueError(
            f"generated knowledge has {len(knowledge)} lines but the test "
            f"TSV has {len(rows)} rows: a silent mismatch would splice the "
            "wrong knowledge into every following row")
    n = 0
    with open(processed_file, "w") as fw:
        for row, k in zip(rows, knowledge):
            topic, context, _, response = row[:4]
            fw.write(f"{topic}\t{context}\t{k}\t{response}\n")
            n += 1
    return n


def main(argv=None, *, device: DeviceLike = None) -> int:
    """The preprocessing CLI (`--func ...`); `device` is where
    get_knwl_gen_prompts runs the biencoder (the current CUDA device when
    None)."""
    import argparse
    p = argparse.ArgumentParser(description="MSDP preprocessing")
    p.add_argument("--func", required=True,
                   choices=["process_wow_dataset", "process_woi_dataset",
                            "get_knwl_gen_prompts", "get_resp_gen_prompts",
                            "prepare_input"])
    p.add_argument("--raw_file")
    p.add_argument("--processed_file")
    p.add_argument("--knwl_ref_file")
    p.add_argument("--resp_ref_file")
    p.add_argument("--knwl_gen_file")
    p.add_argument("--test_file")
    p.add_argument("--train_file")
    p.add_argument("--model_file")
    p.add_argument("--data_type",
                   choices=["wow_seen", "wow_unseen", "woi"])
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)

    if args.func == "process_wow_dataset":
        n = process_wow_dataset(args.raw_file, args.processed_file,
                                args.knwl_ref_file, args.resp_ref_file)
    elif args.func == "process_woi_dataset":
        n = process_woi_dataset(args.raw_file, args.processed_file,
                                args.knwl_ref_file, args.resp_ref_file)
    elif args.func == "get_knwl_gen_prompts":
        n = prompt_selection_for_knowledge_generation(
            args.test_file, args.train_file, args.model_file,
            args.processed_file, args.data_type, device=device)
    elif args.func == "get_resp_gen_prompts":
        n = prompt_selection_for_response_generation(
            args.train_file, args.processed_file, args.seed)
    else:
        n = prepare_input_for_response_generation(
            args.test_file, args.knwl_gen_file, args.processed_file)
    print(f"{args.func}: wrote {n} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
