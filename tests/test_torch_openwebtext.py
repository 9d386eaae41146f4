"""The port's corpus-cleaning suite (megatron_tpu_torch/tools/openwebtext/)
and tokenize_corpus.sh against the root ones: every case of
tests/test_openwebtext.py runs on the root modules and again on the port's,
in two directories, and must pass both times and leave byte-equal files;
the two tokenize_corpus.sh scripts turn one tiny corpus into byte-equal
.bin/.idx files."""
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import pytest

from megatron_tpu_torch.tools import synthetic_corpus as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("add_id", "blacklist_urls", "cleanup_dataset",
           "cleanup_fix_dataset", "filter_ngrams", "find_duplicates",
           "group_duplicate_url", "merge_jsons", "owt_utils",
           "remove_group_duplicates")
CASES = ("test_blacklist_urls", "test_registered_domain",
         "test_cleanup_dataset", "test_cleanup_fix_dataset",
         "test_duplicate_pipeline", "test_minhash_similarity_tracks_jaccard",
         "test_filter_ngrams", "test_add_id_and_merge")


def _reference_tests():
    spec = importlib.util.spec_from_file_location(
        "root_openwebtext_cases", os.path.join(ROOT, "tests",
                                               "test_openwebtext.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", CASES)
def test_port_suite_gives_the_reference_outputs(case, tmp_path,
                                                monkeypatch):
    ref = _reference_tests()
    fn = getattr(ref, case)
    takes_dir = "tmp_path" in inspect.signature(fn).parameters
    out = {}
    for pkg in ("root", "port"):
        if pkg == "port":
            for name in MODULES:
                port = importlib.import_module(
                    f"megatron_tpu_torch.tools.openwebtext.{name}")
                assert port.__file__.startswith(
                    os.path.join(ROOT, "megatron_tpu_torch"))
                monkeypatch.setattr(ref, name, port)
        d = tmp_path / pkg
        d.mkdir()
        fn(d) if takes_dir else fn()
        out[pkg] = _files(d)
    assert out["port"] == out["root"]


def test_tokenize_corpus_script_matches_the_root_script(tmp_path):
    vocab, merges = sc.write_gpt2_vocab(str(tmp_path), 600)
    train = sc.write_jsonl(str(tmp_path / "train.jsonl"), 12, 3,
                           min_words=5, max_words=30)
    valid = sc.write_jsonl(str(tmp_path / "valid.jsonl"), 4, 4,
                           min_words=5, max_words=30)
    env = dict(os.environ, WORKERS="1", JAX_PLATFORMS="cpu",
               PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    outs = {}
    for name, script in (("root", "tools/tokenize_corpus.sh"),
                         ("port",
                          "megatron_tpu_torch/tools/tokenize_corpus.sh")):
        (tmp_path / name).mkdir()
        subprocess.run(
            ["bash", os.path.join(ROOT, script), train, valid,
             os.path.join(name, "corpus"), "GPT2BPETokenizer",
             "--vocab_file", vocab, "--merge_file", merges],
            cwd=str(tmp_path), env=env, check=True, capture_output=True,
            timeout=300)
        outs[name] = _files(tmp_path / name)
    assert sorted(outs["port"]) == sorted(outs["root"])
    assert {os.path.splitext(k)[1] for k in outs["port"]} == {".bin", ".idx"}
    assert len(outs["port"]) == 4
    for key, data in outs["root"].items():
        assert outs["port"][key] == data, key
    meta = json.dumps(sorted(outs["port"]))
    assert "corpus-train" in meta and "corpus-valid" in meta
