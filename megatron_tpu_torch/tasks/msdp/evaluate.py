"""MSDP F1 evaluation: generated against golden responses
(tasks/msdp/evaluate.py)."""
from __future__ import annotations

from megatron_tpu_torch.tasks.msdp.metrics import F1Metric


def evaluate_f1(guess_file: str, answer_file: str) -> dict:
    """Line-aligned F1 between two text files. <|endoftext|> is stripped
    from the guesses; `no_passages_used` references count as empty."""
    with open(guess_file, encoding="utf-8") as f:
        guesses = [line.strip().replace("<|endoftext|>", "")
                   for line in f]
    with open(answer_file, encoding="utf-8") as f:
        answers = ["" if line.strip() == "no_passages_used"
                   else line.strip() for line in f]
    if len(guesses) != len(answers):
        raise ValueError("lengths of guess and answer are different!")
    precision, recall, f1 = F1Metric.compute_all_pairs(guesses, answers)
    print(f"Precision: {precision:.4f}; recall: {recall:.4f}; "
          f"f1: {f1:.4f}")
    return {"precision": precision, "recall": recall, "f1": f1}
