"""The port's host data tools against the JAX package's, on the CPU:
`scripts/{pretokenize,pretokenize_pairs,shard_tools,build_index,
tokenizer_compare}.py` and the C++ data plane (`native/`).

Each tool runs on the same locally built inputs on both sides, into
directories of their own, and writes the same files: byte for byte, except
that a gzip file is compared decompressed (its header carries the time of
writing), a path that names the output directory is compared with that
directory's name swapped, and the HF `datasets` directory of pretokenize
is compared by its arrow data files and rows (its state.json carries a
random fingerprint). Held against tests/test_scripts.py:14,51,60,77,
tests/test_shard_tools.py:21,64,78,126 and tests/test_native.py:31-87:
  - TokenPacker / pack_tokens windows, tokenizer_compare;
  - pretokenize's packed dataset, pretokenize_pairs' .tokens shards,
    counts.json and spec.yaml (and the port's StreamingShardDataset reads
    them back as the jsonl bucket's batches);
  - shard_tools to_paired (per-language dirs too), filter, lengths, sizes;
  - build_index's counts.json and offsets.json.gz;
  - the native plane: offsets equal to the Python path's, index_many,
    stream reads at rank-batch windows and a rewind, the streaming loader
    reading through it, and a corrupt gzip: None from the plane and an
    error from build_bucket_index.
"""

import filecmp
import gzip
import json
import os
import sys

import numpy as np
import pytest

from contrastors_tpu.data.indexing import build_bucket_index as j_build_bucket_index, index_shard as j_index_shard
from contrastors_tpu.scripts import pretokenize as JP
from contrastors_tpu.scripts import pretokenize_pairs as JPP
from contrastors_tpu.scripts import shard_tools as JST
from contrastors_tpu.scripts import tokenizer_compare as JTC
from contrastors_tpu_torch.data.indexing import build_bucket_index, index_shard
from contrastors_tpu_torch.scripts import build_index as TBI
from contrastors_tpu_torch.scripts import pretokenize as TP
from contrastors_tpu_torch.scripts import pretokenize_pairs as TPP
from contrastors_tpu_torch.scripts import shard_tools as TST
from contrastors_tpu_torch.scripts import tokenizer_compare as TTC

from test_data import make_bucket, make_tokenizer
from test_native import make_shard


def _jax_main(module, argv, monkeypatch):
    """A JAX CLI whose main reads sys.argv."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    return module.main()


def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def assert_same_tree(a, b, swap=()):
    """Every file under a equal to b's (gz decompressed; each (x, y) of
    swap replaced in a's bytes before the comparison)."""
    files_a = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b and files_a
    for rel in files_a:
        got = _read(os.path.join(a, rel))
        for x, y in swap:
            got = got.replace(x.encode(), y.encode())
        assert got == _read(os.path.join(b, rel)), rel


def test_token_packer_matches_jax():
    docs = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11]]
    assert list(TP.pack_tokens(docs, 4, 0)) == list(JP.pack_tokens(docs, 4, 0)) == [[1, 2, 3, 0], [4, 5, 0, 6],
                                                                                     [7, 8, 9, 10]]
    docs = [[i, i + 1, i + 2] for i in range(0, 40, 3)]
    packer = TP.TokenPacker(max_length=8, sep_id=0)
    split = [w for lo in range(0, len(docs), 2) for w in packer.add(docs[lo:lo + 2])]
    assert split == list(JP.pack_tokens(docs, max_length=8, sep_id=0))


def test_tokenizer_compare_matches_jax(tmp_path, monkeypatch, capsys):
    from transformers import BertTokenizerFast

    a = make_tokenizer(tmp_path)
    (tmp_path / "b").mkdir()
    vocab_b = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"word{i}" for i in range(0, 60, 2)]
    (tmp_path / "b" / "vocab.txt").write_text("\n".join(vocab_b))
    b = BertTokenizerFast(vocab_file=str(tmp_path / "b" / "vocab.txt"))
    texts = ["word1 word2", "word3", "word4 word40 word58", "q word2"]
    assert TTC.compare(a, b, texts) == JTC.compare(a, b, texts)
    assert TTC.compare(a, a, texts)["identical_tokenizations"] == 1.0
    for tok, d in ((a, "a_dir"), (b, "b_dir")):
        tok.save_pretrained(str(tmp_path / d))
    (tmp_path / "texts.txt").write_text("\n".join(texts) + "\n\n")
    argv = ["--a", str(tmp_path / "a_dir"), "--b", str(tmp_path / "b_dir"), "--texts", str(tmp_path / "texts.txt")]
    got = TTC.main(argv)
    port_out = capsys.readouterr().out
    _jax_main(JTC, argv, monkeypatch)
    assert got == JTC.compare(a, b, texts) and port_out == capsys.readouterr().out


def test_pretokenize_matches_jax(tmp_path, monkeypatch):
    from datasets import load_from_disk

    tok_dir = tmp_path / "tok"
    make_tokenizer(tmp_path).save_pretrained(str(tok_dir))
    rng = np.random.default_rng(0)
    (tmp_path / "in").mkdir()
    with open(tmp_path / "in" / "a.jsonl", "w") as f:
        for _ in range(40):
            f.write(json.dumps({"text": " ".join(f"word{w}" for w in rng.integers(0, 50, rng.integers(1, 30)))}) + "\n")
    with open(tmp_path / "in" / "b.txt", "w") as f:
        for _ in range(20):
            f.write(" ".join(f"word{w}" for w in rng.integers(0, 50, rng.integers(1, 30))) + "\n\n")
    outs = {}
    for side, run in (("port", lambda argv: TP.main(argv)), ("jax", lambda argv: _jax_main(JP, argv, monkeypatch))):
        outs[side] = str(tmp_path / f"packed_{side}")
        run(["--input", str(tmp_path / "in" / "*"), "--tokenizer", str(tok_dir), "--max_length", "16",
             "--output", outs[side], "--val_pct", "0.1"])
    got, want = load_from_disk(outs["port"]), load_from_disk(outs["jax"])
    for split in ("train", "validation"):
        assert got[split]["input_ids"] == want[split]["input_ids"] and len(got[split]) > 0
        for f in os.listdir(os.path.join(outs["jax"], split)):
            if f.endswith(".arrow"):
                assert filecmp.cmp(os.path.join(outs["port"], split, f), os.path.join(outs["jax"], split, f),
                                   shallow=False)
    assert all(len(r) == 16 for r in got["train"]["input_ids"])


@pytest.mark.parametrize("flags", [[], ["--num_negatives", "2", "--add_prefix", "--query_max_length", "8"]],
                         ids=["default", "negatives_prefix"])
def test_pretokenize_pairs_matches_jax_and_streams_back(tmp_path, monkeypatch, flags):
    import yaml

    from contrastors_tpu_torch.data.text import StreamingShardDataset

    spec = make_bucket(tmp_path)
    if flags:  # a triplet objective with hard negatives and prefixes
        bucket = tmp_path / "data" / "pairs"
        for s in range(2):
            path = bucket / f"shard-{s:05d}.jsonl.gz"
            rows = [json.loads(x) for x in gzip.open(path, "rt")]
            with gzip.open(path, "wt") as f:
                for r in rows:
                    r["negative"] = [f"d word{(r['row_id'] * k) % 50}" for k in (3, 5, 11)]
                    r["metadata"] = {"objective": {"triplet": [["query", "document", "negative"]]}}
                    f.write(json.dumps(r) + "\n")
        j_build_bucket_index(str(bucket))
        raw = yaml.safe_load(open(spec))
        raw["datasets"][0].update(objective={"type": "triplet", "columns": ["query", "document", "negative"]},
                                  query_prefix="search_query", document_prefix="search_document")
        with open(spec, "w") as f:
            yaml.safe_dump(raw, f)
    tok_dir = tmp_path / "tok"
    make_tokenizer(tmp_path).save_pretrained(str(tok_dir))
    outs = {side: str(tmp_path / f"pretok_{side}") for side in ("port", "jax")}
    TPP.main(["--spec", spec, "--tokenizer", str(tok_dir), "--out", outs["port"]] + flags)
    _jax_main(JPP, ["--spec", spec, "--tokenizer", str(tok_dir), "--out", outs["jax"]] + flags, monkeypatch)
    assert_same_tree(outs["port"], outs["jax"], swap=[("pretok_port", "pretok_jax")])
    if flags:
        return
    # the port's loader reads the .tokens shards as the jsonl bucket's batches
    tok = make_tokenizer(tmp_path)
    kw = dict(global_batch_size=8, tokenizer=tok, seed=0, process_index=0, process_count=1)
    a = list(StreamingShardDataset(spec, state_dir=str(tmp_path / "sa"), **kw))
    b = list(StreamingShardDataset(os.path.join(outs["port"], "spec.yaml"), state_dir=str(tmp_path / "sb"), **kw))
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        for k in ("query_input_ids", "document_input_ids", "query_attention_mask", "document_attention_mask"):
            assert np.array_equal(x[k], y[k]), k


def _corpus(path, n=25, lang=None):
    with gzip.open(path, "wt") as f:
        for i in range(n):
            row = {"text": f"Title {i}\nBody text number {i} with some words."}
            if lang is not None:
                row["lang"] = lang[i % len(lang)]
            f.write(json.dumps(row) + "\n")


def _both(tmp_path, argv_of, capsys):
    """Run shard_tools with argv_of(side) on both sides: (port stdout, JAX
    stdout), each with its own output paths swapped for the side's name
    (and the port's package name, in the command it suggests, for JAX's)."""
    out = {}
    for side, fn in (("port", TST.main), ("jax", JST.main)):
        fn(argv_of(side))
        out[side] = capsys.readouterr().out.replace(side, "SIDE").replace("contrastors_tpu_torch.", "contrastors_tpu.")
    return out["port"], out["jax"]


def test_shard_tools_to_paired_and_index_match_jax(tmp_path, capsys):
    corpus = tmp_path / "corpus.jsonl.gz"
    _corpus(str(corpus))
    mc = tmp_path / "multi.jsonl.gz"
    _corpus(str(mc), n=20, lang=["en", "de"])

    def argv(side, src=corpus, extra=()):
        return ["to_paired", "--input", str(src), "--output_dir", str(tmp_path / f"{side}_{src.name}"),
                "--query_col", "query", "--document_col", "document", "--split_title_text", *extra]

    got, want = _both(tmp_path, lambda side: argv(side, extra=("--shard_size", "10")), capsys)
    assert got == want
    got, want = _both(tmp_path, lambda side: argv(side, mc, ("--lang_col", "lang", "--shard_size", "100")), capsys)
    assert got == want
    for src in (corpus, mc):
        assert_same_tree(str(tmp_path / f"port_{src.name}"), str(tmp_path / f"jax_{src.name}"))
    # build_index on the port's bucket, JAX's index on JAX's: the same files
    TBI.main(["--bucket", str(tmp_path / f"port_{corpus.name}")])
    j_build_bucket_index(str(tmp_path / f"jax_{corpus.name}"))
    assert_same_tree(str(tmp_path / f"port_{corpus.name}"), str(tmp_path / f"jax_{corpus.name}"),
                     swap=[("port_", "jax_")])
    assert "3 shards, 25 rows" in capsys.readouterr().out


def test_shard_tools_filter_lengths_sizes_match_jax(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    for s in range(2):
        with gzip.open(src / f"shard-0000{s}.jsonl.gz", "wt") as f:
            for i in range(10):
                gid = s * 10 + i
                f.write(json.dumps({"query": f"q{gid}", "document": "d" * (gid + 1)}) + "\n")
    ids = tmp_path / "ids"
    ids.mkdir()
    (ids / "ids_to_keep_0.json").write_text(json.dumps([0, 3, 12, 19]))
    for extra in (["--ids_dir", str(ids)], ["--min_chars", "15", "--require_cols", "document"],
                  ["--ids_dir", str(ids), "--drop"]):
        got, want = _both(tmp_path, lambda side: ["filter", "--input_dir", str(src), "--output_dir",
                                                  str(tmp_path / f"{side}_filtered")] + extra, capsys)
        assert got == want
        assert_same_tree(str(tmp_path / "port_filtered"), str(tmp_path / "jax_filtered"))
    got, want = _both(tmp_path, lambda side: ["lengths", "--input_dir", str(src), "--column", "document"], capsys)
    assert got == want and "p50=" in got
    got, want = _both(tmp_path, lambda side: ["sizes", str(src)], capsys)
    assert got == want and json.loads(got.strip().splitlines()[-1]) == {str(src): 20}


# -- the native data plane ------------------------------------------------------
@pytest.fixture(scope="module")
def native():
    import contrastors_tpu_torch.native as n

    assert n.get_lib() is not None, "g++ and zlib are in this image: the plane must build"
    return n


def test_native_index_matches_python(tmp_path, native):
    path = make_shard(tmp_path)
    assert native.index_file(path) == index_shard(path) == j_index_shard(path)
    paths = [make_shard(tmp_path, rows=100 + i, name=f"s{i}.jsonl.gz") for i in range(5)]
    assert native.index_many(paths, n_threads=4) == [index_shard(p) for p in paths]
    assert native.library_path().parent.name == "_build"


def test_native_stream_reads(tmp_path, native):
    path = make_shard(tmp_path, rows=500)
    offsets = index_shard(path)
    with gzip.open(path, "rb") as f:
        blob = f.read()
    s = native.NativeGzipStream(path)
    for start_row in (0, 100, 250):
        lo, hi = offsets[str(start_row)][0], offsets[str(start_row + 9)][1]
        s.seek(lo)
        assert s.read(hi - lo) == blob[lo:hi]
    s.seek(0)
    assert s.read(10) == blob[:10]
    s.close()


def test_streaming_dataset_reads_through_the_native_plane(tmp_path, native):
    from contrastors_tpu_torch.data.text import StreamingShardDataset

    spec = make_bucket(tmp_path)
    ds = StreamingShardDataset(spec, global_batch_size=8, tokenizer=make_tokenizer(tmp_path), seed=0,
                               process_index=0, process_count=1, state_dir=str(tmp_path / "state"))
    it = iter(ds)
    batches = [next(it)]
    assert any(isinstance(s, native.NativeGzipStream) for s in ds._streams.values())
    batches += list(it)
    assert len(batches) == 8 and not ds._streams


def test_native_corrupt_gzip_surfaces_error(tmp_path, native):
    good = tmp_path / "b" / "good.jsonl.gz"
    good.parent.mkdir()
    with gzip.open(good, "wt") as f:
        for i in range(200):
            f.write(f'{{"i": {i}, "pad": "{"x" * 100}"}}\n')
    blob = bytearray(good.read_bytes())
    for off in range(len(blob) // 2, len(blob) // 2 + 16):
        blob[off] ^= 0xFF
    bad = tmp_path / "b" / "bad.jsonl.gz"
    bad.write_bytes(bytes(blob))
    res = native.index_many([str(good), str(bad)])
    assert res[0] is not None and len(res[0]) == 200
    assert res[1] is None, "a corrupt shard must surface as an error, not a partial index"
    with pytest.raises(Exception):
        build_bucket_index(str(tmp_path / "b"))
