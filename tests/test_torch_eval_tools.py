"""The port's eval side against JAX's: the offline MTEB harness, its tools,
the LoCo converters, the BEIR runner, the long-context encoder and the
baseline encoders.

- `mini_mteb`'s numpy metrics on the same arrays: equal within 1e-6.
- `eval_mteb.main` end to end over the six task types, on the tiny BERT
  checkpoint with its written vocab, both sides in fp32 (JAX's main
  hard-codes bf16; a test-local wrap of its `load_biencoder` asks for
  fp32): every main score within 1e-3 of JAX's, plain, with
  --matryoshka_dim and with --binarize, on graded tasks (`graded_tasks`:
  pairs that share some words, scored by how many). The data of
  tests/test_mini_mteb.py pairs identical sentences, whose cosines are 1
  within an ulp on either side, so its STS ranking among them is decided
  by rounding; on it the port is held to that test's own bars instead.
- `mteb_tools` (merge, partial refusal, score table, model card) and
  `loco_data` (SCROLLS, QASPER, the BEIR files) equal to JAX's outputs.
- `run_beir_dirs` with one deterministic stand-in encoder on both sides.
- `build_long_context_encoder` on a rotary checkpoint trained to 32
  positions: every bucket of 64, 128 and 256 tokens asks for the rotary
  table JAX's asks for, bit for bit, and the embeddings agree with JAX's at
  cosine >= 0.9999 in fp32, with DynamicNTK on (seq_len 256) and off.
- `HFEncoder` on the CPU against the port's Encoder and JAX's HFEncoder,
  and `OpenAIEncoder`'s offline refusal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastors_tpu.eval import mini_mteb as j_mini
from contrastors_tpu.eval import mteb_tools as j_tools
from contrastors_tpu_torch.eval import mini_mteb as mini
from contrastors_tpu_torch.eval import mteb_tools as tools

from test_mini_mteb import make_mteb_data
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_metrics_equal_jax_on_the_same_arrays():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=40), rng.normal(size=40)
    b[::5] = b[1]  # ties, average-ranked
    assert abs(mini.spearman(a, b) - j_mini.spearman(a, b)) <= 1e-6
    labels = rng.integers(0, 2, size=40)
    assert abs(mini.average_precision(a, labels) - j_mini.average_precision(a, labels)) <= 1e-6
    t, p = rng.integers(0, 4, size=60), rng.integers(0, 5, size=60)
    assert abs(mini.v_measure(t, p) - j_mini.v_measure(t, p)) <= 1e-6
    x = rng.normal(size=(60, 8))
    np.testing.assert_array_equal(mini.kmeans(x.copy(), 4, seed=1), j_mini.kmeans(x.copy(), 4, seed=1))
    y = np.array(["a", "b", "c"])[rng.integers(0, 3, size=60)]
    xt = rng.normal(size=(20, 8))
    np.testing.assert_array_equal(mini.softmax_regression(x, y, xt), j_mini.softmax_regression(x, y, xt))


VARIANTS = {"plain": [], "matryoshka": ["--matryoshka_dim", "16"], "binarize": ["--binarize"]}


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def graded_tasks(root, seed=0):
    """One task of each type over the checkpoint's 100 words, with no
    identical texts: STS pairs share 0-6 of 6 words and score that count,
    duplicate questions share 5 of 6, the classes and clusters draw from
    disjoint halves of the vocab, retrieval and reranking queries take 3
    words of their document."""
    rng = np.random.default_rng(seed)

    def sent(n=6, lo=0, hi=100):
        return [f"word{x}" for x in rng.integers(lo, hi, size=n)]

    def mix(a, keep):
        b = list(a[:keep]) + sent(len(a) - keep)
        rng.shuffle(b)
        return b

    os.makedirs(root)
    d = os.path.join(root, "SciFact")
    os.makedirs(d)
    docs = [sent(8) for _ in range(24)]
    _write_jsonl(os.path.join(d, "corpus.jsonl"), [{"_id": f"d{i}", "title": "", "text": " ".join(w)}
                                                   for i, w in enumerate(docs)])
    _write_jsonl(os.path.join(d, "queries.jsonl"), [{"_id": f"q{i}", "text": " ".join(docs[i][:3])}
                                                    for i in range(12)])
    with open(os.path.join(d, "qrels.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n" + "".join(f"q{i}\td{i}\t1\n" for i in range(12)))
    rows = []
    for i in range(24):
        a, keep = sent(), i % 7
        rows.append({"sentence1": " ".join(a), "sentence2": " ".join(mix(a, keep)), "score": float(keep)})
    os.makedirs(os.path.join(root, "STSBenchmark"))
    _write_jsonl(os.path.join(root, "STSBenchmark", "pairs.jsonl"), rows)
    d = os.path.join(root, "Banking77Classification")
    os.makedirs(d)
    label = lambda n: [{"text": " ".join(sent(lo=50 * g, hi=50 * g + 50)), "label": g}  # noqa: E731
                       for _ in range(n) for g in (0, 1)]
    _write_jsonl(os.path.join(d, "train.jsonl"), label(10))
    _write_jsonl(os.path.join(d, "test.jsonl"), label(6))
    os.makedirs(os.path.join(root, "TwentyNewsgroupsClustering"))
    _write_jsonl(os.path.join(root, "TwentyNewsgroupsClustering", "docs.jsonl"), label(10))
    rows = []
    for i in range(12):
        a = sent()
        rows.append({"sentence1": " ".join(a), "sentence2": " ".join(mix(a, 5)), "label": 1})
        rows.append({"sentence1": " ".join(sent()), "sentence2": " ".join(sent()), "label": 0})
    os.makedirs(os.path.join(root, "SprintDuplicateQuestions"))
    _write_jsonl(os.path.join(root, "SprintDuplicateQuestions", "pairs.jsonl"), rows)
    rows = []
    for i in range(8):
        pos = sent(8)
        rows.append({"query": " ".join(pos[:3]), "positive": [" ".join(pos)],
                     "negative": [" ".join(sent(8)) for _ in range(3)]})
    os.makedirs(os.path.join(root, "SciDocsRR"))
    _write_jsonl(os.path.join(root, "SciDocsRR", "samples.jsonl"), rows)
    return ["SciFact", "STSBenchmark", "Banking77Classification", "TwentyNewsgroupsClustering",
            "SprintDuplicateQuestions", "SciDocsRR"]


@pytest.fixture(scope="module")
def mteb_runs(tmp_path_factory):
    """{variant: (JAX's results dir, the port's)} over the six tasks."""
    import contrastors_tpu.models.auto as j_auto
    from contrastors_tpu.eval.eval_mteb import main as j_main

    from contrastors_tpu_torch.eval.eval_mteb import main as t_main

    tmp = tmp_path_factory.mktemp("mteb")
    ckpt = make_checkpoint_dir(tmp)
    tasks = graded_tasks(str(tmp / "data"))
    j_load = j_auto.load_biencoder
    runs = {}
    try:
        j_auto.load_biencoder = lambda margs, dtype=None, **kw: j_load(margs, dtype=jnp.float32, **kw)
        for name, extra in VARIANTS.items():
            common = ["--model_name", ckpt, "--seq_len", "16", "--batch_size", "8",
                      "--local_data_dir", str(tmp / "data"), "--tasks", *tasks] + extra
            j_dir, t_dir = str(tmp / f"jax_{name}"), str(tmp / f"port_{name}")
            j_main(common + ["--output_dir", j_dir])
            t_main(common + ["--output_dir", t_dir, "--device", "cpu", "--dtype", "fp32"])
            runs[name] = (j_dir, t_dir)
    finally:
        j_auto.load_biencoder = j_load
    return tasks, runs


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_mteb_main_scores_match_jax(mteb_runs, variant):
    tasks, runs = mteb_runs
    j_dir, t_dir = runs[variant]
    for task in tasks:
        with open(os.path.join(j_dir, f"{task}.json")) as f, open(os.path.join(t_dir, f"{task}.json")) as g:
            want, got = json.load(f), json.load(g)
        assert got["mteb_dataset_name"] == task
        assert set(got["test"]) == set(want["test"])
        assert np.isfinite(got["test"]["main_score"])
        assert abs(got["test"]["main_score"] - want["test"]["main_score"]) <= 1e-3, (task, got, want)
    assert tools.score_table(t_dir)["n_tasks"] == len(tasks)


def test_eval_mteb_main_meets_the_jax_tests_bars_on_their_data(mteb_runs, tmp_path):
    """tests/test_mini_mteb.py's data and bars: identical-text retrieval and
    reranking perfect, every score in range, six task types."""
    from contrastors_tpu_torch.eval.eval_mteb import main as t_main

    _, runs = mteb_runs
    ckpt = os.path.join(os.path.dirname(runs["plain"][1]), "tiny-bert")
    tasks = make_mteb_data(tmp_path / "data")
    out = str(tmp_path / "res")
    t_main(["--model_name", ckpt, "--seq_len", "16", "--batch_size", "8", "--local_data_dir",
            str(tmp_path / "data"), "--output_dir", out, "--tasks", *tasks, "--device", "cpu"])
    table = tools.score_table(out)
    assert set(table["per_task"]) == set(tasks) and len(table["per_type"]) == 6
    assert table["per_task"]["SciFact"] == pytest.approx(1.0)
    assert table["per_task"]["SciDocsRR"] == pytest.approx(1.0)
    assert all(-1.0 <= v <= 1.0 for v in table["per_task"].values())
    assert "MTEB SciFact" in open(tools.mteb_meta(out, "port-test")).read()


def test_run_mteb_over_a_loaded_model_writes_what_main_writes(mteb_runs, tmp_path):
    from contrastors_tpu_torch.eval.encoder import auto_tokenizer, load_encoder_model
    from contrastors_tpu_torch.eval.eval_mteb import run_mteb

    tasks, runs = mteb_runs
    ckpt = os.path.join(os.path.dirname(runs["plain"][1]), "tiny-bert")
    module, _ = load_encoder_model(ckpt, dtype="fp32", device="cpu")
    out = run_mteb(module, auto_tokenizer(ckpt), tasks, str(tmp_path / "res"),
                   local_data_dir=os.path.join(os.path.dirname(ckpt), "data"), seq_len=16, batch_size=8)
    assert set(out) == set(tasks)
    for task in tasks:
        with open(os.path.join(runs["plain"][1], f"{task}.json")) as f:
            assert json.load(f)["test"]["main_score"] == out[task]["test"]["main_score"]
    with pytest.raises(SystemExit, match="mteb"):
        run_mteb(module, auto_tokenizer(ckpt), tasks[:1], str(tmp_path / "x"))


def _write_result(d, task, scores):
    with open(os.path.join(d, f"{task}.json"), "w") as f:
        json.dump({"mteb_dataset_name": task, "test": scores}, f)


def test_mteb_tools_equal_jax(tmp_path):
    dirs = []
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        os.makedirs(d)
        for i, t in enumerate(tools.CQADUPSTACK_SUBSETS):
            _write_result(d, t, {"ndcg_at_10": 0.30 + i * 0.01, "recall_at_100": 0.5})
        _write_result(d, "NFCorpus", {"ndcg_at_10": 0.35})
        _write_result(d, "STSBenchmark", {"cos_sim": {"spearman": 0.85}})
        _write_result(d, "Banking77Classification", {"accuracy": 0.80})
        _write_result(d, "SprintDuplicateQuestions", {"scores": 1, "cos_sim": {"ap": 0.9}})
        dirs.append(d)
    j_d, t_d = dirs
    assert os.path.basename(tools.merge_cqadupstack(t_d)) == "CQADupstackRetrieval.json"
    j_tools.merge_cqadupstack(j_d)
    with open(os.path.join(j_d, "CQADupstackRetrieval.json")) as f, \
            open(os.path.join(t_d, "CQADupstackRetrieval.json")) as g:
        assert json.load(g) == json.load(f)
    table = tools.score_table(t_d)
    assert table == j_tools.score_table(j_d)
    assert table["n_tasks"] == 5
    with open(tools.mteb_meta(t_d, "org/my-model")) as f, open(j_tools.mteb_meta(j_d, "org/my-model")) as g:
        assert f.read() == g.read()
    partial = str(tmp_path / "partial")
    os.makedirs(partial)
    for t in tools.CQADUPSTACK_SUBSETS[:5]:
        _write_result(partial, t, {"ndcg_at_10": 0.3})
    with pytest.raises(FileNotFoundError, match="subsets missing"):
        tools.merge_cqadupstack(partial)
    assert tools.merge_cqadupstack(str(tmp_path)) is None
    tools.main(["score", "--results_dir", t_d])


def test_loco_converters_equal_jax(tmp_path):
    from datasets import Dataset, DatasetDict

    from contrastors_tpu.eval import loco_data as j_loco
    from contrastors_tpu_torch.eval import loco_data as loco

    scrolls = str(tmp_path / "gov_report")
    DatasetDict({"validation": Dataset.from_dict({
        "input": [f"long document {i} " * 5 for i in range(6)], "output": [f"summary {i}" for i in range(6)],
    })}).save_to_disk(scrolls)
    qasper = str(tmp_path / "qasper")
    Dataset.from_dict({
        "abstract": ["abs one", "abs two"],
        "full_text": [{"section_name": ["Intro", None, "Methods"], "paragraphs": [["a b", "c"], ["floating"], []]},
                      {"section_name": [None], "paragraphs": [[]]}],
    }).save_to_disk(qasper)
    for load, j_load, path in ((loco.load_scrolls, j_loco.load_scrolls, scrolls),
                               (loco.load_qasper, j_loco.load_qasper, qasper)):
        got, want = load(path), j_load(path)
        assert got == want
        t_dir = loco.export_beir_dir(*got, str(tmp_path / f"beir_{os.path.basename(path)}"))
        j_dir = j_loco.export_beir_dir(*want, str(tmp_path / f"jbeir_{os.path.basename(path)}"))
        for name in ("corpus.jsonl", "queries.jsonl", "qrels.tsv"):
            with open(os.path.join(t_dir, name)) as f, open(os.path.join(j_dir, name)) as g:
                assert f.read() == g.read()
    corpus, queries, qrels = loco.load_qasper(qasper)
    assert corpus["Passage_0"]["text"] == "Intro\na b c\nfloating\nMethods"
    assert qrels["Query_1"] == {"Passage_1": 1} and queries["Query_1"] == "abs two"
    loco.main(["--dataset", "gov_report", "--path", scrolls, "--output", str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == ["corpus.jsonl", "qrels.tsv", "queries.jsonl"]


class ToyEncoder:
    """A deterministic bag-of-words embedding, the same on both sides."""

    def encode_queries(self, texts, **kw):
        return self._emb(texts)

    def encode_corpus(self, docs, **kw):
        return self._emb([d["text"] if isinstance(d, dict) else d for d in docs])

    def _emb(self, texts):
        out = np.zeros((len(texts), 16), np.float32)
        for i, t in enumerate(texts):
            for tok in t.split():
                out[i, int(tok.removeprefix("word")) % 16] += 1
        return out / (np.linalg.norm(out, axis=1, keepdims=True) + 1e-6)


def test_run_beir_dirs_equals_jax(tmp_path):
    from contrastors_tpu.eval.retrieval import run_beir_dirs as j_run
    from contrastors_tpu_torch.eval.loco_data import export_beir_dir
    from contrastors_tpu_torch.eval.retrieval import run_beir_dirs

    rng = np.random.default_rng(0)
    dirs = []
    for k, parent in enumerate(("a", "b")):  # the same basename twice
        words = [rng.integers(0, 40, size=5) for _ in range(12)]
        corpus = {f"d{i}": {"title": "", "text": " ".join(f"word{x}" for x in w)} for i, w in enumerate(words)}
        queries = {f"q{i}": " ".join(f"word{x}" for x in words[i][:3]) for i in range(6)}
        qrels = {f"q{i}": {f"d{i}": 1} for i in range(6)}
        dirs.append(export_beir_dir(corpus, queries, qrels, str(tmp_path / parent / "nano")))
    got = run_beir_dirs(ToyEncoder(), dirs, ks=(1, 10), output=str(tmp_path / "out.json"))
    assert got == j_run(ToyEncoder(), dirs, ks=(1, 10))
    assert set(got) == {"nano", "nano+", "avg"}
    with open(tmp_path / "out.json") as f:
        assert json.load(f) == got


def rotary_checkpoint(tmp_path):
    """A 2-layer rotary BERT trained to 32 positions, with a written vocab."""
    from safetensors.torch import save_file
    from transformers import BertConfig, BertModel, BertTokenizerFast

    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=64, type_vocab_size=2,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    d = cfg.to_dict()
    d.update(rotary_emb_fraction=1.0, rotary_emb_base=1000, max_trained_positions=32)
    ckpt = tmp_path / "rot-bert"
    ckpt.mkdir()
    with open(ckpt / "config.json", "w") as f:
        json.dump(d, f)
    save_file({k: v.contiguous() for k, v in BertModel(cfg).state_dict().items()}, str(ckpt / "model.safetensors"))
    with open(ckpt / "vocab.txt", "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"word{i}" for i in range(100)]))
    BertTokenizerFast(vocab_file=str(ckpt / "vocab.txt")).save_pretrained(str(ckpt))
    return str(ckpt)


@pytest.mark.parametrize("seq_len", [256, 32], ids=["ntk_on_256", "ntk_off_32"])
def test_long_context_encoder_matches_jax_bucket_by_bucket(tmp_path, monkeypatch, seq_len):
    """Texts of 40, 100 and 200 words, one a batch: with seq_len 256 the
    buckets are 64, 128 and 256 tokens, each past the trained 32, and each
    asks both sides for the same NTK-scaled table."""
    import contrastors_tpu.layers.attention as j_attn
    from contrastors_tpu.eval.eval_long_context import build_long_context_encoder as j_build

    import contrastors_tpu_torch.layers.attention as t_attn
    from contrastors_tpu_torch.eval.eval_long_context import build_long_context_encoder

    ckpt = rotary_checkpoint(tmp_path)
    texts = [" ".join(f"word{i % 90}" for i in range(n)) for n in (40, 100, 200)]
    calls = {"jax": [], "port": []}
    make = {"jax": j_attn.rotary_cos_sin, "port": t_attn.rotary_cos_sin}

    def spy(side):
        def wrapped(seqlen, rotary_dim, **kw):
            calls[side].append((seqlen, rotary_dim, {k: v for k, v in kw.items() if k != "device"}))
            return make[side](seqlen, rotary_dim, **kw)
        return wrapped

    monkeypatch.setattr(j_attn, "rotary_cos_sin", spy("jax"))
    monkeypatch.setattr(t_attn, "rotary_cos_sin", spy("port"))
    j_enc = j_build(ckpt, seq_len=seq_len, rotary_scaling_factor=2.0, batch_size=1, dtype=jnp.float32)
    enc = build_long_context_encoder(ckpt, seq_len=seq_len, rotary_scaling_factor=2.0, batch_size=1,
                                     dtype="fp32", device="cpu")
    factor = 2.0 if seq_len > 32 else None
    calls["jax"].clear(), calls["port"].clear()  # JAX's init traced a dummy batch
    assert enc.module.trunk.config.rotary_scaling_factor == j_enc.module.config.rotary_scaling_factor == factor
    want, got = j_enc.encode(texts), enc.encode(texts)
    cos = (want * got).sum(-1)
    assert cos.min() >= 0.9999, cos
    # one table per length: JAX traces each bucket once, the port caches per layer
    j_tables = {c[0]: c for c in calls["jax"]}
    t_tables = {c[0]: c for c in calls["port"]}
    lengths = [64, 128, 256] if seq_len == 256 else [32]
    assert sorted(j_tables) == sorted(t_tables) == lengths
    for length in lengths:
        (_, j_dim, j_kw), (_, t_dim, t_kw) = j_tables[length], t_tables[length]
        assert t_dim == j_dim == 16 and t_kw == j_kw and t_kw["rotary_scaling_factor"] == factor
        j_cos, j_sin = make["jax"](length, j_dim, **j_kw)
        t_cos, t_sin = make["port"](length, t_dim, device="cpu", **t_kw)
        np.testing.assert_array_equal(t_cos.numpy(), np.asarray(j_cos))
        np.testing.assert_array_equal(t_sin.numpy(), np.asarray(j_sin))


def test_hf_encoder_on_the_cpu_matches_the_port_and_jax(tmp_path):
    from contrastors_tpu.eval.encoder import HFEncoder as JHFEncoder
    from contrastors_tpu_torch.eval.encoder import Encoder, HFEncoder, auto_tokenizer, load_encoder_model

    ckpt = make_checkpoint_dir(tmp_path)
    sents = [f"word{i} word{i + 2} word{i + 5}" for i in range(6)]
    hf = HFEncoder(ckpt, seq_len=16, batch_size=4, device="cpu")
    got = hf.encode(sents)
    np.testing.assert_allclose(got, JHFEncoder(ckpt, seq_len=16, batch_size=4).encode(sents), atol=1e-6)
    module, _ = load_encoder_model(ckpt, dtype="fp32", device="cpu")
    port = Encoder(module, auto_tokenizer(ckpt), seq_len=16, batch_size=4, query_prefix=None,
                   document_prefix=None).encode(sents)
    assert (got * port).sum(-1).min() > 0.9999
    assert hf.encode_queries(sents[:2]).shape == (2, 64)


def test_openai_encoder_refuses_offline():
    from contrastors_tpu_torch.eval.encoder import OpenAIEncoder

    with pytest.raises(ImportError, match="openai"):
        OpenAIEncoder(embedding_model="text-embedding-ada-002", batch_size=8)
