"""The port's MSDP pipeline (tasks/msdp) on the CPU against the JAX
package's.

- F1 (`normalize_answer`, `F1Metric`, `evaluate_f1`) equal on the
  reference test's cases and on random pairs;
- `read_prompts`, `build_input` and `_first_line` equal;
- WoW and WoI processing write byte-equal files (with and without the
  reference files, which change WoI's later contexts);
- `get_database`, both prompt selections and
  `prepare_input_for_response_generation` write byte-equal files;
  knowledge-prompt selection through `biencoder_encode_fn` on a biencoder
  checkpoint the JAX package's npz writer saved: embeddings within 1e-5 of
  JAX's, the same prompts in the same order;
- `generate_samples` through the port's `Generator` equals JAX's greedy
  text in fp32, and `make_api_fn` against the port's own server on the CPU
  equals the in-process path;
- `tasks.msdp.main` MSDP-PROMPT (in process, an npz checkpoint JAX wrote)
  and MSDP-EVAL-F1, and the preprocessing CLI, beside the reference's.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data.tokenizers import build_tokenizer as jbuild
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.models.bert import bert_config as jbert_config
from megatron_tpu.models.biencoder import biencoder_init
from megatron_tpu.training.checkpointing import save_checkpoint
from megatron_tpu.training.train_step import TrainState as JTrainState
from megatron_tpu.training.train_step import state_from_params
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.data.tokenizers import build_tokenizer as tbuild
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.inference.server import MegatronServer
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.tasks.msdp import evaluate as tev
from megatron_tpu_torch.tasks.msdp import main as tmain
from megatron_tpu_torch.tasks.msdp import metrics as tmet
from megatron_tpu_torch.tasks.msdp import preprocessing as tpp
from megatron_tpu_torch.tasks.msdp import prompt as tpr
from megatron_tpu_torch.tools import synthetic_corpus as sc
from tasks.msdp import evaluate as jev
from tasks.msdp import main as jmain
from tasks.msdp import metrics as jmet
from tasks.msdp import preprocessing as jpp
from tasks.msdp import prompt as jpr

torch.set_num_threads(2)
WORDS = ["coffee", "tea", "brewed", "from", "beans", "leaves", "how", "is",
         "made", "what", "about", "the", "a", "an", "panda", "bamboo",
         "forest", "china", "river", "city", "north", "old", "it", "this",
         "great", "wall", "built", "across"]
TOPICS = ["Coffee", "Tea", "Panda", "Wall", "River"]


def _phrase(rs, lo, hi, end=""):
    return " ".join(rs.choice(WORDS, rs.randint(lo, hi + 1))) + end


# -- F1 and prompts ------------------------------------------------------

def test_f1_equals_jax():
    cases = [("the cat", "cat"), ("dog", "cat"), ("big red dog", "red cat"),
             ("x", ""), ("", "red"), ("The Quick, Brown Fox!", "quick fox")]
    rs = np.random.RandomState(0)
    for _ in range(200):
        cases.append((_phrase(rs, 0, 8, rs.choice([".", "!", ",", ""])),
                      _phrase(rs, 0, 8)))
    for guess, answer in cases:
        assert tmet.normalize_answer(guess) == jmet.normalize_answer(guess)
        assert (tmet.F1Metric.compute_each_pair(guess, answer)
                == jmet.F1Metric.compute_each_pair(guess, answer))
    guesses, answers = zip(*cases)
    assert (tmet.F1Metric.compute_all_pairs(list(guesses), list(answers))
            == jmet.F1Metric.compute_all_pairs(list(guesses),
                                               list(answers)))
    # the reference test's pins
    assert tmet.F1Metric.compute_all_pairs(["x", "red"], ["", "red"])[2] \
        == 1.0


def test_evaluate_f1_files_equal_jax(tmp_path, capsys):
    g, a = tmp_path / "g.txt", tmp_path / "a.txt"
    rs = np.random.RandomState(1)
    g.write_text("red dog<|endoftext|>\nhello\n" + "".join(
        _phrase(rs, 1, 6) + "\n" for _ in range(30)))
    a.write_text("red dog\nno_passages_used\n" + "".join(
        _phrase(rs, 1, 6) + "\n" for _ in range(30)))
    want = jev.evaluate_f1(str(g), str(a))
    want_out = capsys.readouterr().out
    assert tev.evaluate_f1(str(g), str(a)) == want
    assert capsys.readouterr().out == want_out
    assert tmain.main(["--task", "MSDP-EVAL-F1", "--guess_file", str(g),
                       "--answer_file", str(a)]) == 0
    assert capsys.readouterr().out == want_out


def test_prompts_equal_jax(tmp_path):
    rs = np.random.RandomState(2)
    kp = tmp_path / "k.jsonl"
    rows, lines = [], []
    for i in range(12):
        topic, last = TOPICS[i % 5], _phrase(rs, 2, 6, "?")
        key = f"{topic} {last}"
        rows.append(f"{topic}\t{_phrase(rs, 2, 5)} [SEP] {last}\t"
                    f"{_phrase(rs, 3, 9, '.')}")
        lines.append(json.dumps({key: [
            f"( {_phrase(rs, 1, 4)} ) {topic} => {_phrase(rs, 3, 8)}  "
            for _ in range(rs.randint(1, 5))]}))
    kp.write_text("\n".join(lines + lines[:2]) + "\n")
    rp = tmp_path / "r.txt"
    rp.write_text("".join(f" example {_phrase(rs, 2, 6)} \n"
                          for _ in range(6)))
    for n in (1, 3, 10):
        kt = tpr.read_prompts(str(kp), "knowledge", n)
        assert kt == jpr.read_prompts(str(kp), "knowledge", n)
        rt = tpr.read_prompts(str(rp), "response", n)
        assert rt == jpr.read_prompts(str(rp), "response", n)
        for row in rows:
            for kind, prompts in (("knowledge", kt), ("response", rt)):
                text = tpr.build_input(row, kind, prompts)
                assert text == jpr.build_input(row, kind, prompts)
                for gen in (text + " more\nnext", "other\nx", text):
                    assert (tpr._first_line(gen, text)
                            == jpr._first_line(gen, text))


# -- preprocessing -------------------------------------------------------

def _wow(rs, n_dialogues):
    out = []
    for d in range(n_dialogues):
        dialog = []
        for t in range(rs.randint(2, 8)):
            wizard = t % 2 == 1
            sentences = ({f"s{i}": _phrase(rs, 3, 9, ".")
                          for i in range(rs.randint(0, 2))} if wizard
                         else {})
            passages = ({f"p{i}": rs.choice(TOPICS)
                         for i in range(rs.randint(0, 3))} if wizard
                        else {})
            dialog.append({
                "speaker": f"{t % 2}_{'Wizard' if wizard else 'Apprentice'}",
                "text": _phrase(rs, 1, 8, rs.choice(["", ".", "?", "!"])),
                "checked_sentence": sentences,
                "checked_passage": passages})
        out.append({"chosen_topic": TOPICS[d % 5], "dialog": dialog})
    return out


def _woi(rs, n_records):
    lines = []
    for r in range(n_records):
        history = []
        for _ in range(rs.randint(2, 9)):
            action = rs.choice(["Apprentice => Wizard",
                                "Wizard => SearchAgent",
                                "Wizard => Apprentice"])
            item = {"action": action,
                    "text": _phrase(rs, 1, 6, rs.choice(["", "\t x",
                                                         "\n y"]))}
            if action == "Wizard => Apprentice":
                contents = [{"content": [_phrase(rs, 2, 6, ".")
                                         for _ in range(rs.randint(1, 4))]}
                            for _ in range(rs.randint(0, 3))]
                selected = [[bool(rs.rand() < 0.2)]] + [
                    [bool(rs.rand() < 0.4) for _ in c["content"]]
                    for c in contents]
                item["context"] = {"contents": contents,
                                   "selected_contents": selected}
            history.append(item)
        lines.append(json.dumps({f"d{r}": {"dialog_history": history}}))
    return "\n".join(lines) + "\n"


def _files_equal(a, b):
    assert open(a, "rb").read() == open(b, "rb").read(), (a, b)


@pytest.mark.parametrize("refs", [False, True])
def test_process_wow_and_woi_write_equal_files(tmp_path, refs):
    rs = np.random.RandomState(3)
    wow = tmp_path / "wow.json"
    wow.write_text(json.dumps(_wow(rs, 12)))
    woi = tmp_path / "woi.jsonl"
    woi.write_text(_woi(rs, 12))
    for kind, raw in (("wow", wow), ("woi", woi)):
        outs = {}
        for name, mod in (("t", tpp), ("j", jpp)):
            files = [str(tmp_path / f"{kind}_{name}_{f}")
                     for f in ("proc.tsv", "knwl.txt", "resp.txt")]
            args = files if refs else files[:1] + [None, None]
            fn = getattr(mod, f"process_{kind}_dataset")
            outs[name] = (fn(str(raw), *args), files)
        assert outs["t"][0] == outs["j"][0] > 0
        for a, b in zip(outs["t"][1], outs["j"][1]):
            if refs or a.endswith("proc.tsv"):
                _files_equal(a, b)


def _tsv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(r) + "\n")
    return str(path)


def _train_test(tmp_path, rs):
    def row(topic, test=False):
        know = (jpp.NO_KNOWLEDGE if rs.rand() < 0.1 else
                f"{topic} {_phrase(rs, 2, 12)}" if rs.rand() < 0.7 else
                _phrase(rs, 2, 25) + rs.choice(["", " (x)"]))
        turns = " [SEP] ".join(_phrase(rs, 2, 6, "?")
                               for _ in range(rs.randint(1, 5)))
        resp = (f"i read that {know} which amazed me" if rs.rand() < 0.3
                else _phrase(rs, 3, 10, "."))
        return [topic, turns, know, resp]

    train = _tsv(tmp_path / "train.tsv", [row(rs.choice(TOPICS[:4]))
                                          for _ in range(40)])
    test = _tsv(tmp_path / "test.tsv",
                [row(rs.choice(TOPICS[2:]) if i % 2 else "Space", True)
                 for i in range(8)])
    return train, test


def _hash_encode(texts):
    out = np.zeros((len(texts), 32), np.float32)
    for i, t in enumerate(texts):
        for w in t.lower().split():
            out[i, sum(map(ord, w)) % 32] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)


@pytest.mark.parametrize("data_type", ["wow_seen", "wow_unseen", "woi"])
def test_prompt_selection_and_inputs_equal_jax(tmp_path, data_type):
    rs = np.random.RandomState(4)
    train, test = _train_test(tmp_path, rs)
    assert (tpp.get_database(test, train, data_type)
            == jpp.get_database(test, train, data_type))
    for n in (2, 10):
        a, b = tmp_path / "kt.jsonl", tmp_path / "kj.jsonl"
        assert tpp.prompt_selection_for_knowledge_generation(
            test, train, None, str(a), data_type, encode_fn=_hash_encode,
            n_prompts=n) == jpp.prompt_selection_for_knowledge_generation(
            test, train, None, str(b), data_type, encode_fn=_hash_encode,
            n_prompts=n)
        _files_equal(a, b)
    a, b = tmp_path / "rt.txt", tmp_path / "rj.txt"
    for seed in (0, 1234):
        assert tpp.prompt_selection_for_response_generation(
            train, str(a), seed) == \
            jpp.prompt_selection_for_response_generation(train, str(b),
                                                         seed)
        _files_equal(a, b)
    gen = tmp_path / "gen.txt"
    gen.write_text("".join(_phrase(rs, 2, 6) + "<|endoftext|>\n"
                           for _ in range(8)))
    a, b = tmp_path / "pt.tsv", tmp_path / "pj.tsv"
    assert tpp.prepare_input_for_response_generation(
        test, str(gen), str(a)) == jpp.prepare_input_for_response_generation(
        test, str(gen), str(b)) == 8
    _files_equal(a, b)


@pytest.fixture(scope="module")
def biencoder_ckpt(tmp_path_factory):
    """A tiny biencoder (flash attention) saved by the JAX package's npz
    writer, with its WordPiece vocabulary in the config."""
    root = tmp_path_factory.mktemp("biencoder")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
        + [t.lower() for t in TOPICS] + ["?", ".", "(", ")", "=", ">"])
        + "\n")
    n_vocab = len(vocab.read_text().split())
    mcfg = jbert_config(num_layers=2, hidden_size=64, num_attention_heads=4,
                        vocab_size=n_vocab, seq_length=32,
                        max_position_embeddings=32, attention_impl="flash",
                        compute_dtype="float32")
    cfg = jc.MegatronConfig(
        model=mcfg, optimizer=jc.OptimizerConfig(lr=1e-3),
        training=jc.TrainingConfig(micro_batch_size=1, global_batch_size=1,
                                   train_iters=1),
        data=jc.DataConfig(tokenizer_type="BertWordPieceLowerCase",
                           vocab_file=str(vocab))).validate(n_devices=1)
    state = state_from_params(biencoder_init(jax.random.PRNGKey(3), mcfg),
                              cfg)
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, state, cfg, iteration=1, backend="npz")
    return ckpt


def test_biencoder_prompt_selection_equals_jax(tmp_path, biencoder_ckpt):
    rs = np.random.RandomState(5)
    train, test = _train_test(tmp_path, rs)
    t_enc = tpp.biencoder_encode_fn(biencoder_ckpt, device="cpu",
                                    batch_size=7)
    j_enc = jpp.biencoder_encode_fn(biencoder_ckpt)
    texts = [_phrase(rs, 1, 30) for _ in range(20)]
    got, want = t_enc(texts), j_enc(texts)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for data_type in ("wow_seen", "woi"):
        a, b = tmp_path / "kt.jsonl", tmp_path / "kj.jsonl"
        assert tpp.main(["--func", "get_knwl_gen_prompts", "--test_file",
                         test, "--train_file", train, "--model_file",
                         biencoder_ckpt, "--processed_file", str(a),
                         "--data_type", data_type], device="cpu") == 0
        jpp.prompt_selection_for_knowledge_generation(
            test, train, None, str(b), data_type, encode_fn=j_enc)
        _files_equal(a, b)


def test_preprocessing_cli_equals_jax(tmp_path):
    rs = np.random.RandomState(6)
    wow = tmp_path / "wow.json"
    wow.write_text(json.dumps(_wow(rs, 4)))
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    for mod, out in ((tpp, a), (jpp, b)):
        assert mod.main(["--func", "process_wow_dataset", "--raw_file",
                         str(wow), "--processed_file", str(out)]) == 0
    _files_equal(a, b)


# -- generation ----------------------------------------------------------

@pytest.fixture(scope="module")
def gpt(tmp_path_factory):
    """A tiny fp32 GPT (flash attention, vocabulary 300 -> 384) on a GPT-2
    BPE vocabulary of 300, saved by the JAX package's npz writer."""
    root = tmp_path_factory.mktemp("msdp_gpt")
    vocab, merges = sc.write_gpt2_vocab(str(root / "tok"), 300)
    common = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                  vocab_size=300, seq_length=512, compute_dtype="float32",
                  attention_impl="flash")
    jcfg, tcfg = jc.gpt_config(**common), tc.gpt_config(**common)
    params = jlm.model_init(jax.random.PRNGKey(7), jcfg)
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, JTrainState(params, None, jnp.int32(1)),
                    jc.MegatronConfig(model=jcfg), iteration=1,
                    backend="npz")
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu"))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                vocab=vocab, merges=merges, ckpt=ckpt, root=root)


def _msdp_files(root, rs, n=5):
    test = root / "test.txt"
    prompts = root / "knwl_prompts.jsonl"
    rows, lines = [], []
    for i in range(n):
        topic, last = TOPICS[i % 5], _phrase(rs, 2, 5, "?")
        rows.append(f"{topic}\t{_phrase(rs, 2, 4)} [SEP] {last}\tgold")
        lines.append(json.dumps({f"{topic} {last}": [
            f"( {_phrase(rs, 1, 3)} ) {topic} => {_phrase(rs, 3, 6)}"
            for _ in range(2)]}))
    test.write_text("\n".join(rows[:2] + [""] + rows[2:]) + "\n")
    prompts.write_text("\n".join(lines) + "\n")
    return str(test), str(prompts)


def test_generate_samples_equal_jax_and_the_api(gpt, tmp_path):
    rs = np.random.RandomState(8)
    test, prompt_file = _msdp_files(tmp_path, rs)
    lines = open(test).readlines()
    prompts = tpr.read_prompts(prompt_file, "knowledge", 10)
    t_tok = tbuild("GPT2BPETokenizer", vocab_file=gpt["vocab"],
                   merge_file=gpt["merges"])
    j_tok = jbuild("GPT2BPETokenizer", vocab_file=gpt["vocab"],
                   merge_file=gpt["merges"])
    gen = Generator(gpt["model"], gpt["tcfg"], t_tok.eod,
                    kv_cache_dtype=torch.float32, device="cpu")
    jgen = JGenerator(gpt["params"], gpt["jcfg"], j_tok.eod,
                      kv_cache_dtype=jnp.float32)
    kw = dict(prompt_type="knowledge", prompts=prompts, out_seq_length=12,
              log_interval=0)
    got = tpr.generate_samples(lines, generate_fn=tpr.make_generator_fn(
        gen, t_tok), **kw)
    want = jpr.generate_samples(lines, generate_fn=jpr.make_generator_fn(
        jgen, j_tok), **kw)
    assert got == want
    assert got[2] == "" and all(got[i] for i in (0, 1, 3))

    server = MegatronServer(gen, t_tok, device="cpu",
                            serving=ServingConfig(num_slots=2))
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        # no scheme, as the example passes it: http:// is put in front
        api = tpr.generate_samples(
            lines, generate_fn=tpr.make_api_fn(f"127.0.0.1:{port}/api"),
            **kw)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.close()
    assert api == got
    assert tpr.api_url("localhost:5000/api") == "http://localhost:5000/api"
    assert tpr.api_url("https://h/api") == "https://h/api"


def test_msdp_prompt_cli_equals_jax(gpt, tmp_path, capsys):
    rs = np.random.RandomState(9)
    test, prompt_file = _msdp_files(tmp_path, rs, n=3)
    outs = {}
    for name, main, extra in (("t", tmain.main, {"device": "cpu"}),
                              ("j", jmain.main, {})):
        out = str(tmp_path / f"out_{name}.txt")
        assert main(["--task", "MSDP-PROMPT", "--prompt_type", "knowledge",
                     "--prompt_file", prompt_file, "--sample_input_file",
                     test, "--sample_output_file", out, "--out_seq_length",
                     "10", "--load", gpt["ckpt"], "--tokenizer_type",
                     "GPT2BPETokenizer", "--vocab_file", gpt["vocab"],
                     "--merge_file", gpt["merges"]], **extra) == 0
        outs[name] = out
    _files_equal(outs["t"], outs["j"])
    assert "msdp: wrote 4 generations" in capsys.readouterr().out
