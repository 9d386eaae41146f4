"""The port's retriever on the CPU against the JAX package: the biencoder's
loss and gradients (separate and shared towers, with and without the
ict_head), the sentence-pair and ICT mappings and samples, the evidence
and NQ datasets, the embedding store both ways, the MIPS index, the
IndexBuilder, the ORQA evaluator, `pretrain_ict.main` and
`create_doc_index.main`, on inputs made from numpy seeds and JAX's
initialised weights carried across by the bridge.

Tolerances and why:
- losses 1e-5 and gradients 1e-4 relative per leaf (as
  tests/test_torch_bert_t5.py: the same fp32 formulas summed in another
  order), each leaf's scale being at least LEAF_FLOOR of the tree's
  largest gradient: the in-batch loss's gradients at random init are
  small sums that cancel (the ict_head's bias sums the rows' embedding
  gradients, sum_i (E_p[c] - c_i) ~ 0 under a near-uniform softmax: ~1e-7
  against ~1e-3 terms), so such a leaf's rounding is measured against
  the terms' scale, not its own;
- mappings, dataset samples, match statistics and the evaluator's metrics
  exactly: the same numpy, C++ and Python draws;
- MIPS ids exactly and scores 1e-5 relative; the chunked search equals the
  unchunked one bit for bit (each query row is scored and ranked alone);
- the stores' fp16 embeddings within one fp16 step (the fp32 embeddings
  agree within ~1e-6 and may round to neighbouring fp16 values);
- pretrain_ict's two losses 1e-5 relative, dropout off (torch cannot
  reproduce jax.random's bits).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data import helpers as jhelpers
from megatron_tpu.data import ict_dataset as jict
from megatron_tpu.data import orqa_dataset as jorqa
from megatron_tpu.data import realm_index as jrealm
from megatron_tpu.data.indexed_dataset import IndexedDatasetBuilder
from megatron_tpu.data.indexed_dataset import MMapIndexedDataset as JIndexed
from megatron_tpu.data.tokenizers import BertWordPieceTokenizer as JWP
from megatron_tpu.indexer import IndexBuilder as JIndexBuilder
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import biencoder as jbi
from megatron_tpu.training import checkpointing as j_ckpt
from megatron_tpu.training import loop as j_loop
from megatron_tpu.training import optimizer as jopt
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import pretrain_ict
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.data import helpers as thelpers
from megatron_tpu_torch.data import ict_dataset as tict
from megatron_tpu_torch.data import orqa_dataset as torqa
from megatron_tpu_torch.data import realm_index as trealm
from megatron_tpu_torch.data.indexed_dataset import \
    MMapIndexedDataset as TIndexed
from megatron_tpu_torch.data.tokenizers import BertWordPieceTokenizer as TWP
from megatron_tpu_torch.indexer import IndexBuilder as TIndexBuilder
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import biencoder as tbi
from megatron_tpu_torch.tasks.orqa import qa_utils as tqa
from megatron_tpu_torch.tasks.orqa.evaluate import \
    ORQAEvaluator as TEvaluator
from megatron_tpu_torch.tools import create_doc_index
from megatron_tpu_torch.training import checkpointing as t_ckpt
from megatron_tpu_torch.training import loop as t_loop
import pretrain_ict as j_pretrain_ict
from tasks.orqa import qa_utils as jqa
from tasks.orqa.evaluate import ORQAEvaluator as JEvaluator

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=300, seq_length=64, compute_dtype="float32")
S, B = 64, 4
LEAF_FLOOR = 1e-2
ICT_BATCH = 16  # the in-batch softmax's rows in pretrain_ict
WORDS = ["the", "quick", "brown", "fox", "dog", "cat", "bird", "runs",
         "paris", "france", "london", "capital", "of", "is", "what",
         "river", "city", "north", "south", "old"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


def _biencoder(impl, shared, head, vocab=300, seed=0):
    kw = dict(TINY, attention_impl=impl, vocab_size=vocab)
    jcfg, tcfg = jbert.bert_config(**kw), tbert.bert_config(**kw)
    params = jbi.biencoder_init(jax.random.PRNGKey(seed), jcfg,
                                ict_head_size=head, shared=shared)
    model = tbi.BiencoderModel.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu",
                                model_cls=tbi.BiencoderModel),
        trainable=True)
    return jcfg, tcfg, params, model


def _batch(seed):
    rs = np.random.RandomState(seed)
    q_mask = (np.arange(S)[None] < rs.randint(8, 24, (B, 1))).astype(
        np.int64)
    c_mask = (np.arange(S)[None] < rs.randint(30, S + 1, (B, 1))).astype(
        np.int64)
    return {"query_tokens": rs.randint(0, 300, (B, S)),
            "context_tokens": rs.randint(0, 300, (B, S)),
            "query_pad_mask": q_mask, "context_pad_mask": c_mask}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --- the biencoder -----------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("head", [None, 16])
def test_retrieval_loss_and_grads_match_jax(shared, head):
    """The in-batch softmax loss and accuracy over padded queries and
    contexts through the flash path, and every gradient leaf."""
    jcfg, tcfg, params, model = _biencoder("flash", shared, head)
    batch = _batch(3)
    (want, want_acc), want_g = jax.value_and_grad(
        jbi.retrieval_loss, has_aux=True)(params, _j(batch), jcfg)
    got, acc = tbi.retrieval_loss(model, _t(batch), tcfg)
    got.backward()
    assert _rel_err(got.item(), want) < 1e-5
    assert acc.item() == float(want_acc)
    grads = _flatten(want_g)
    assert len(grads) == len(list(model.parameters()))
    floor = LEAF_FLOOR * max(np.abs(np.asarray(g)).max()
                             for g in grads.values())
    for name, p in model.named_parameters():
        want_g = np.asarray(grads[name.replace(".", "/")])
        # the token-type table takes no gradient without token types
        got_g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        scale = max(np.abs(want_g).max(), floor)
        assert np.abs(got_g - want_g).max() / scale < 1e-4, name


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_embed_text_matches_jax(impl):
    """One tower's embeddings with token types and a pad mask."""
    jcfg, tcfg, params, model = _biencoder(impl, False, 16, seed=4)
    batch = _batch(5)
    types = (np.arange(S)[None] >= 10).repeat(B, 0).astype(np.int64)
    want = jbi.embed_text(params["context_model"],
                          jnp.asarray(batch["context_tokens"]), jcfg,
                          padding_mask=jnp.asarray(batch["context_pad_mask"]),
                          tokentype_ids=jnp.asarray(types))
    with torch.no_grad():
        got = tbi.embed_text(model["context_model"],
                             torch.from_numpy(batch["context_tokens"]), tcfg,
                             padding_mask=torch.from_numpy(
                                 batch["context_pad_mask"]),
                             tokentype_ids=torch.from_numpy(types))
    assert got.dtype == torch.float32 and got.shape == (B, 16)
    assert _rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("shared", [False, True])
def test_biencoder_tree_and_weight_decay_mask_match_jax(shared):
    """The tree's names and shapes, the options read back off it, and the
    weight-decay mask against JAX's logical axes."""
    jcfg, tcfg, params, model = _biencoder("dot", shared, 16)
    flat = _flatten(params)
    state = model.state_dict()
    assert sorted(state) == sorted(k.replace("/", ".") for k in flat)
    assert model.options == {"ict_head_size": 16, "shared": shared}
    want = _flatten(jopt.weight_decay_mask(
        params, jbi.biencoder_axes(jcfg, ict_head_size=16, shared=shared)))
    got = tts.weight_decay_mask(model)
    assert got == {k.replace("/", "."): bool(v) for k, v in want.items()}


# --- mappings and samples ----------------------------------------------------

def _corpus(n_docs, seed, sent_range=(1, 9), len_range=(3, 20),
            vocab=300):
    rng = np.random.default_rng(seed)
    sentences, docs = [], [0]
    for _ in range(n_docs):
        for _ in range(int(rng.integers(*sent_range))):
            sentences.append(rng.integers(5, vocab, size=int(
                rng.integers(*len_range))).astype(np.int64))
        docs.append(len(sentences))
    return sentences, np.asarray(docs, np.int64)


@pytest.mark.parametrize("seed,epochs,max_len,short", [
    (0, 1, 20, 0.1), (1, 3, 48, 0.0), (2, 2, 12, 0.5)])
def test_mappings_equal(seed, epochs, max_len, short):
    sentences, docs = _corpus(30, seed)
    sizes = np.asarray([len(s) for s in sentences], np.int32)
    titles = np.random.default_rng(seed).integers(0, 6, len(docs) - 1)
    kw = dict(num_epochs=epochs, max_num_samples=10 ** 6,
              max_seq_length=max_len, seed=seed + 7)
    np.testing.assert_array_equal(
        thelpers.build_mapping_native(docs, sizes, short_seq_prob=short,
                                      **kw),
        jhelpers.build_mapping_native(docs, sizes, short_seq_prob=short,
                                      **kw))
    for one in (False, True):
        got = thelpers.build_blocks_mapping_native(
            docs, sizes, titles, use_one_sent_blocks=one, **kw)
        want = jhelpers.build_blocks_mapping_native(
            docs, sizes, titles, use_one_sent_blocks=one, **kw)
        assert got.dtype == want.dtype and len(got)
        np.testing.assert_array_equal(got, want)


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], list):
            assert a[k] == b[k], k
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def sentence_corpus(tmp_path_factory):
    """A sentence-split indexed dataset (one sentence a row, documents by
    doc_idx) and its titles, one row a document, over VOCAB's ids."""
    tmp = tmp_path_factory.mktemp("ict")
    sentences, docs = _corpus(24, 11, sent_range=(2, 7), vocab=len(VOCAB))
    prefix, titles = str(tmp / "sents"), str(tmp / "titles")
    b, bt = IndexedDatasetBuilder(prefix), IndexedDatasetBuilder(titles)
    rng = np.random.default_rng(12)
    for d in range(len(docs) - 1):
        for i in range(docs[d], docs[d + 1]):
            b.add_item(sentences[i].tolist())
        b.end_document()
        bt.add_item(rng.integers(5, len(VOCAB), size=int(
            rng.integers(1, 5))).tolist())
        bt.end_document()
    b.finalize()
    bt.finalize()
    return {"sents": prefix, "titles": titles, "tmp": tmp}


def test_sentence_pair_samples_bit_equal(sentence_corpus):
    kw = dict(num_epochs=2, max_num_samples=10 ** 6, max_seq_length=48,
              short_seq_prob=0.2, vocab_size=300, cls_id=2, sep_id=3,
              mask_id=4, pad_id=0, seed=5)
    jds = JIndexed(sentence_corpus["sents"])
    tds = TIndexed(sentence_corpus["sents"])
    want = jict.BertSentencePairDataset(jds, jds.doc_idx, sizes=jds.sizes,
                                        **kw)
    got = tict.BertSentencePairDataset(tds, tds.doc_idx, sizes=tds.sizes,
                                       **kw)
    assert len(got) == len(want) > 10
    for i in range(len(want)):
        _same(got[i], want[i])


@pytest.mark.parametrize("titles", [False, True])
def test_ict_samples_bit_equal(sentence_corpus, titles):
    kw = dict(max_seq_length=40, query_in_block_prob=0.3, cls_id=2,
              sep_id=3, pad_id=0, seed=9)
    jds = JIndexed(sentence_corpus["sents"])
    tds = TIndexed(sentence_corpus["sents"])
    jt = JIndexed(sentence_corpus["titles"]) if titles else None
    tt = TIndexed(sentence_corpus["titles"]) if titles else None
    want = jict.ICTDataset(jds, jds.doc_idx, jt, sizes=jds.sizes, **kw)
    got = tict.ICTDataset(tds, tds.doc_idx, tt, sizes=tds.sizes, **kw)
    assert len(got) == len(want) > 10
    for i in range(len(want)):
        _same(got[i], want[i])


# --- evidence, questions and the store ---------------------------------------

PASSAGES = [
    ("paris is the capital of france", "France"),
    ("london is the capital", "London"),
    ("the quick brown fox runs north", "Fox"),
    ("the old city of paris", "Paris"),
    ("what bird runs south", "Bird"),
    ("the dog is old", "Dog"),
    ("a river runs north of the city", "River"),
]
QUESTIONS = [("what is the capital of france", ["paris"]),
             ("what runs north", ["fox"]),
             ("the old dog", ["dog", "cat"]),
             ("what is the zebra", ["zebra"])]


@pytest.fixture(scope="module")
def retrieval_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orqa")
    vocab = tmp / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    tsv = tmp / "psgs.tsv"
    tsv.write_text("id\ttext\ttitle\n" + "".join(
        f"{i + 1}\t{t}\t{h}\n" for i, (t, h) in enumerate(PASSAGES)))
    qa_tsv = tmp / "nq.tsv"
    qa_tsv.write_text("".join(f"{q}\t{a!r}\n" for q, a in QUESTIONS))
    qa_jsonl = tmp / "nq.jsonl"
    qa_jsonl.write_text("".join(
        '{"question": "%s", "answers": %s}\n' % (q, str(a).replace(
            "'", '"')) for q, a in QUESTIONS))
    return {"vocab": str(vocab), "tsv": str(tsv), "qa": str(qa_tsv),
            "qa_jsonl": str(qa_jsonl), "tmp": tmp}


def test_evidence_and_nq_samples_bit_equal(retrieval_files):
    f = retrieval_files
    jtok, ttok = JWP(f["vocab"]), TWP(f["vocab"])
    want = jorqa.OpenRetrievalEvidenceDataset(f["tsv"], jtok, 16)
    got = torqa.OpenRetrievalEvidenceDataset(f["tsv"], ttok, 16)
    assert len(got) == len(want) == len(PASSAGES)
    assert got.id2text == want.id2text
    for i in range(len(want)):
        _same(got[i], want[i])
    for wb, gb in zip(want.batches(3, shard=1, num_shards=2),
                      got.batches(3, shard=1, num_shards=2)):
        _same(gb, wb)
    for path in (f["qa"], f["qa_jsonl"]):
        want = jorqa.NQDataset(path, jtok, 12)
        got = torqa.NQDataset(path, ttok, 12)
        assert len(got) == len(QUESTIONS)
        for i in range(len(want)):
            _same(got[i], want[i])
        for wb, gb in zip(want.batches(3), got.batches(3)):
            _same(gb, wb)
    np.testing.assert_array_equal(
        torqa.build_tokens_types_paddings_from_ids(range(5, 30), 16, 2, 3,
                                                   0),
        jorqa.build_tokens_types_paddings_from_ids(range(5, 30), 16, 2, 3,
                                                   0))


def _store_rows(seed, n=12, d=8):
    rs = np.random.RandomState(seed)
    return rs.permutation(100)[:n], rs.standard_normal((n, d))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_loads_in_the_other(tmp_path, writer):
    """Shards saved by one package, merged by the other, loaded by the
    first: the same sorted ids and fp16 embeddings."""
    w, r = (jrealm, trealm) if writer == "jax" else (trealm, jrealm)
    path = str(tmp_path / "emb.npz")
    ids, emb = _store_rows(0)
    for rank in (0, 1):
        store = w.OpenRetrievalDataStore(path, load_from_path=False,
                                         rank=rank)
        store.add_block_data(ids[rank::2], emb[rank::2])
        store.save_shard()
    merged = r.OpenRetrievalDataStore(path, load_from_path=False)
    merged.merge_shards_and_save()
    assert not os.path.exists(merged.temp_dir_name)
    back = w.OpenRetrievalDataStore(path)
    assert len(back) == len(ids)
    for i, e in zip(ids, emb):
        assert back.embed_data[int(i)].dtype == np.float16
        np.testing.assert_array_equal(back.embed_data[int(i)],
                                      e.astype(np.float16))
    with np.load(path) as z:
        assert z["ids"].dtype == np.int64 and z["embeds"].dtype == np.float16
        assert list(z["ids"]) == sorted(int(i) for i in ids)


def test_mips_ids_match_jax_and_chunks_equal_one_block():
    rs = np.random.RandomState(1)
    ids = rs.permutation(5000)[:700]
    emb = rs.standard_normal((700, 16)).astype(np.float32)
    queries = rs.standard_normal((37, 16)).astype(np.float32)
    want = jbi.MIPSIndex(16)
    want.add_block_data(ids[:300], emb[:300])
    want.add_block_data(ids[300:], emb[300:])
    w_scores, w_ids = want.search_mips_index(queries, 20)
    whole = tbi.MIPSIndex(16, device="cpu")
    chunked = tbi.MIPSIndex(16, device="cpu", score_bytes=4 * 700 * 5)
    for index in (whole, chunked):
        index.add_block_data(ids[:300], emb[:300])
        index.add_block_data(torch.from_numpy(ids[300:]),
                             torch.from_numpy(emb[300:]))
    assert whole.chunk_rows() == tbi.SCORE_BYTES // (4 * 700)
    assert chunked.chunk_rows() == 5
    scores, got = whole.search_mips_index(queries, 20)
    np.testing.assert_array_equal(got, w_ids)
    assert _rel_err(scores, w_scores) < 1e-5
    c_scores, c_ids = chunked.search_mips_index(queries, 20)
    np.testing.assert_array_equal(c_ids, got)
    np.testing.assert_array_equal(c_scores, scores)
    # k past the rows: every row, ranked
    assert whole.search_mips_index(queries[:2], 10 ** 4)[1].shape == (2, 700)


def test_calculate_matches_equal():
    rs = np.random.RandomState(2)
    docs = {i + 1: (t, h) for i, (t, h) in enumerate(PASSAGES)}
    answers = [a for _, a in QUESTIONS] + [["capital of france"],
                                           ["Paris"]]
    closest = [(list(rs.permutation(np.arange(1, 9))[:6]),
                list(rs.standard_normal(6))) for _ in answers]
    for match in ("string", "regex"):
        want = jqa.calculate_matches(docs, answers, closest, match)
        got = tqa.calculate_matches(docs, answers, closest, match)
        assert got.top_k_hits == want.top_k_hits
        assert got.questions_doc_hits == want.questions_doc_hits


# --- the index builder, the evaluator and the entry points -------------------

def _index_setup(files, impl="flash"):
    jtok, ttok = JWP(files["vocab"]), TWP(files["vocab"])
    kw = dict(TINY, attention_impl=impl, vocab_size=jtok.vocab_size,
              seq_length=16, max_position_embeddings=16)
    jcfg, tcfg = jbert.bert_config(**kw), tbert.bert_config(**kw)
    params = jbi.biencoder_init(jax.random.PRNGKey(6), jcfg,
                                ict_head_size=8)
    model = tbi.BiencoderModel.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu",
                                model_cls=tbi.BiencoderModel))
    return jtok, ttok, jcfg, tcfg, params, model


def _within_fp16_step(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k].astype(np.float32), want[k].astype(np.float32)
        step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
            np.float16)).astype(np.float32)
        assert (np.abs(a - b) <= step).all(), k


def test_index_builder_and_evaluator_match_jax(retrieval_files, tmp_path):
    """The port's IndexBuilder store against JAX's within one fp16 step,
    and against one batch-by-batch embed_text pass; the two evaluators'
    metrics on the one store are equal."""
    f = retrieval_files
    jtok, ttok, jcfg, tcfg, params, model = _index_setup(f)
    jev = jorqa.OpenRetrievalEvidenceDataset(f["tsv"], jtok, 16)
    tev = torqa.OpenRetrievalEvidenceDataset(f["tsv"], ttok, 16)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = JIndexBuilder(params, jcfg, jev, embedding_path=jpath,
                         batch_size=3, log_interval=0).build_and_save_index()
    builder = TIndexBuilder(model, tcfg, tev, embedding_path=tpath,
                            batch_size=3, log_interval=0, device="cpu")
    got = builder.build_and_save_index()
    _within_fp16_step(got.embed_data, want.embed_data)
    one = {}
    for batch in tev.batches(len(tev)):
        for i, e in zip(batch["row_id"], builder.embed(batch).numpy()):
            one[int(i)] = e.astype(np.float16)
    _within_fp16_step(got.embed_data, one)

    for store in (jpath, tpath):
        jm = JEvaluator(params, jcfg, evidence_dataset=jev,
                        embedding_path=store).evaluate(
            f["qa"], jtok, seq_length=12, top_k=5, batch_size=3)
        tm = TEvaluator(model, tcfg, evidence_dataset=tev,
                        embedding_path=store, device="cpu").evaluate(
            f["qa"], ttok, seq_length=12, top_k=5, batch_size=3)
        assert tm == jm
        assert sorted(tm) == ["top1", "top5"]


def _ict_cfgs(vocab):
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              seq_length=32, max_position_embeddings=32, vocab_size=vocab,
              attention_impl="dot", compute_dtype="float32")
    return jc.MegatronConfig(model=jbert.bert_config(**kw))


def _ict_argv(f, corpus, save, load, micro):
    return ["--data_path", corpus["sents"], "--titles_data_path",
            corpus["titles"], "--vocab_file", f["vocab"],
            "--tokenizer_type", "BertWordPieceLowerCase", "--num_layers",
            "2", "--hidden_size", "64", "--num_attention_heads", "4",
            "--seq_length", "32", "--max_position_embeddings", "32",
            "--micro_batch_size", str(micro), "--global_batch_size",
            str(ICT_BATCH), "--train_iters", "2", "--lr", "1e-2",
            "--log_interval", "1", "--attention_impl", "dot",
            "--ict_head_size", "8", "--load", load, "--save", save,
            "--save_interval", "2"]


def _recording(module, losses):
    make = module.make_train_step

    def recording_make(*a, **k):
        step = make(*a, **k)

        def recorded(*sa, **sk):
            state, m = step(*sa, **sk)
            losses.append(float(m["lm_loss"]))
            return state, m
        return recorded
    return recording_make


def test_pretrain_ict_matches_jax_and_feeds_the_index(
        retrieval_files, sentence_corpus, monkeypatch, tmp_path):
    """JAX's initial biencoder state saved as an npz checkpoint at
    iteration 0; both packages' pretrain_ict resume from it and train 2
    iterations on the dot path (the flash path's parity is the loss
    test's): the losses agree. The port's checkpoint then feeds
    create_doc_index (a store equal to the IndexBuilder's on the same
    weights), and its --merge joins two shards."""
    f = retrieval_files
    vocab = JWP(f["vocab"]).vocab_size
    cfg = _ict_cfgs(vocab)
    params = jbi.biencoder_init(jax.random.PRNGKey(8), cfg.model,
                                ict_head_size=8)
    init = str(tmp_path / "init")
    j_ckpt.save_checkpoint(init, jts.state_from_params(params, cfg), cfg, 0,
                           backend="npz")
    jl, tl = [], []
    monkeypatch.setattr(j_loop, "make_train_step", _recording(j_loop, jl))
    monkeypatch.setattr(t_loop, "make_train_step", _recording(t_loop, tl))
    jsave, tsave = str(tmp_path / "j"), str(tmp_path / "t")
    # JAX's entry point takes the test mesh's devices as data parallelism:
    # its micro-batch is a device's share of the one batch of ICT_BATCH
    n_dev = len(jax.devices())
    assert j_pretrain_ict.main(_ict_argv(f, sentence_corpus, jsave, init,
                                         ICT_BATCH // n_dev)) == 0
    assert pretrain_ict.main(_ict_argv(f, sentence_corpus, tsave, init,
                                       ICT_BATCH), device="cpu") == 0
    assert len(tl) == len(jl) == 2
    for got, want in zip(tl, jl):
        assert _rel_err(got, want) < 1e-5
    assert t_ckpt.read_tracker(tsave) == "2"

    emb = str(tmp_path / "emb.npz")
    argv = ["--load", tsave, "--evidence_data_path", f["tsv"],
            "--embedding_path", emb, "--vocab_file", f["vocab"],
            "--retriever_seq_length", "16", "--indexer_batch_size", "3",
            "--ict_head_size", "8"]
    assert create_doc_index.main(argv, device="cpu") == 0
    ttok = TWP(f["vocab"])
    tcfg = tbert.bert_config(
        num_layers=2, hidden_size=64, num_attention_heads=4,
        vocab_size=vocab, seq_length=32, max_position_embeddings=32,
        attention_impl="dot", compute_dtype="float32")
    flat = t_ckpt.read_params(t_ckpt.tracked_dir(tsave))
    model = tbi.BiencoderModel.from_state_dict(
        tcfg, params_from_numpy(flat, tcfg, device="cpu",
                                model_cls=tbi.BiencoderModel))
    ev = torqa.OpenRetrievalEvidenceDataset(f["tsv"], ttok, 16)
    want = TIndexBuilder(model, tcfg, ev, embedding_path=str(
        tmp_path / "x.npz"), batch_size=3, log_interval=0,
        device="cpu").build_and_save_index(save=False)
    _within_fp16_step(trealm.OpenRetrievalDataStore(emb).embed_data,
                      want.embed_data)
    sharded = str(tmp_path / "sharded.npz")
    for shard in (0, 1):
        assert create_doc_index.main(
            [*argv[:4], "--embedding_path", sharded, *argv[6:],
             "--shard", str(shard), "--num_shards", "2"], device="cpu") == 0
    assert create_doc_index.main([*argv[:4], "--embedding_path", sharded,
                                  *argv[6:], "--merge"], device="cpu") == 0
    _within_fp16_step(trealm.OpenRetrievalDataStore(sharded).embed_data,
                      want.embed_data)


def test_create_doc_index_refuses_an_orbax_checkpoint(retrieval_files,
                                                      tmp_path):
    root = tmp_path / "orbax"
    (root / "iter_0000001" / "state").mkdir(parents=True)
    (root / "latest_checkpointed_iteration.txt").write_text("1")
    f = retrieval_files
    with pytest.raises(NotImplementedError, match="orbax"):
        create_doc_index.main(
            ["--load", str(root), "--evidence_data_path", f["tsv"],
             "--embedding_path", str(tmp_path / "e.npz"), "--vocab_file",
             f["vocab"], "--num_layers", "2", "--hidden_size", "64",
             "--num_attention_heads", "4", "--retriever_seq_length", "16"],
            device="cpu")


def test_retrieval_entry_points_raise_without_gpu(monkeypatch,
                                                  retrieval_files):
    """MIPSIndex, IndexBuilder, ORQAEvaluator, pretrain_ict and
    create_doc_index raise without a GPU unless a CPU device is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbi.MIPSIndex(8)
    tbi.MIPSIndex(8, device="cpu")
    _, ttok, _, tcfg, _, model = _index_setup(retrieval_files, "dot")
    ev = torqa.OpenRetrievalEvidenceDataset(retrieval_files["tsv"], ttok, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIndexBuilder(model, tcfg, ev, embedding_path="unused.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEvaluator(model, tcfg, evidence_dataset=ev,
                   embedding_path="unused.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_ict.main(["--data_path", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_doc_index.main(["--load", "x", "--evidence_data_path", "y",
                               "--embedding_path", "z"])
