"""The port's pair data against the JAX package's.

The same files and the same `BertTokenizerFast` go to both sides, and every
batch's numpy arrays must be equal element for element (values, shapes and
dtypes), with the same dataset name: `LocalJsonlDataset` over paired and
triplet records (num_negatives 0, 2 and -1 with the collator's cycle-pad,
sample_negatives on and off, add_prefix on and off, two epochs), and
`StreamingShardDataset` over a local bucket built as tests/test_data.py
builds one, indexed by either side's `build_bucket_index`, over
pretokenized shards and over triplets with teacher scores. Resuming from
`save_state` (with and without `note_consumed`, as the trainer's prefetch
uses it) gives the next batch of the uninterrupted run. The last test
collates through `StubTokenizer`, the stand-in the card's script uses.
"""

import gzip
import json
import random

import numpy as np
import pytest

from contrastors_tpu.data import text as jtext
from contrastors_tpu.data.indexing import build_bucket_index as j_build_bucket_index
from contrastors_tpu_torch.data import text as ttext
from contrastors_tpu_torch.data.indexing import build_bucket_index
from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer

from test_data import _pretokenize, make_bucket, make_tokenizer, make_triplet_bucket


def _arrays(batch):
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def assert_same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a["dataset_name"] == b["dataset_name"]
        aa, bb = _arrays(a), _arrays(b)
        assert sorted(aa) == sorted(bb)
        for k in aa:
            assert aa[k].dtype == bb[k].dtype and aa[k].shape == bb[k].shape, k
            np.testing.assert_array_equal(aa[k], bb[k], err_msg=k)


def _records(path, triplet, n=40, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            rec = {"query": f"q word{i % 50} word{(3 * i) % 50}", "document": f"d word{(7 * i) % 50}"}
            if triplet:  # 1 to 4 negatives, so that 2 cycle-pads and -1 is ragged
                rec["negatives"] = [f"word{x}" for x in rng.integers(0, 50, size=1 + i % 4)]
            f.write(json.dumps(rec) + "\n")
    return str(path)


LOCAL_CASES = [
    # (objective type, num_negatives, sample_negatives, add_prefix)
    ("paired", -1, False, False),
    ("paired", -1, False, True),
    ("triplet", 0, True, False),
    ("triplet", 2, True, True),
    ("triplet", 2, False, False),
    ("triplet", -1, True, False),
    ("triplet", -1, False, True),
]


@pytest.mark.parametrize("kind,num_negatives,sample_negatives,add_prefix", LOCAL_CASES)
def test_local_jsonl_batches_match_jax(tmp_path, kind, num_negatives, sample_negatives, add_prefix):
    tok = make_tokenizer(tmp_path)
    path = _records(tmp_path / "train.jsonl", kind == "triplet")
    columns = ["query", "document", "negatives"] if kind == "triplet" else ["query", "document"]
    kw = dict(global_batch_size=8, tokenizer=tok, objective={"type": kind, "columns": columns}, seed=3,
              add_eos=False, add_prefix=add_prefix, num_negatives=num_negatives,
              sample_negatives=sample_negatives, query_max_length=8, document_max_length=12)
    ours, theirs = ttext.LocalJsonlDataset([path], **kw), jtext.LocalJsonlDataset([path], **kw)
    assert ours.num_batches() == theirs.num_batches() == 5
    for _ in range(2):  # two epochs: the shuffle and sampling RNGs carry over
        assert_same_batches(list(ours), list(theirs))


@pytest.mark.parametrize("index_by", ["port", "jax"])
def test_streaming_batches_match_jax(tmp_path, index_by):
    tok = make_tokenizer(tmp_path)
    spec = make_bucket(tmp_path, n_shards=3, rows_per_shard=24)
    bucket = tmp_path / "data" / "pairs"
    (build_bucket_index if index_by == "port" else j_build_bucket_index)(str(bucket))
    kw = dict(global_batch_size=8, tokenizer=tok, seed=11, add_prefix=True, process_index=0, process_count=1,
              weighted_sampling=True)
    ours = ttext.StreamingShardDataset(spec, state_dir=str(tmp_path / "s_port"), **kw)
    theirs = jtext.StreamingShardDataset(spec, state_dir=str(tmp_path / "s_jax"), **kw)
    assert len(ours) == len(theirs) == 72
    a, b = list(ours), list(theirs)
    assert_same_batches(a, b)
    assert [x["cursor_snapshot"]["cursor"] for x in a] == [x["cursor_snapshot"]["cursor"] for x in b]


@pytest.mark.parametrize("kind", ["pretokenized", "triplet_kd"])
def test_streaming_shard_kinds_match_jax(tmp_path, kind):
    """Token-array shards (JAX's scripts/pretokenize_pairs), and triplet
    records with teacher scores gathered with the sampled negatives."""
    tok = make_tokenizer(tmp_path)
    if kind == "pretokenized":
        spec = _pretokenize(tmp_path, make_bucket(tmp_path), flags=["--add_prefix"])
        kw = dict(add_prefix=True)
    else:
        spec = make_triplet_bucket(tmp_path, neg_counts=(3, 4, 5, 3), rows=32, scores=True, kd_loss=True)
        kw = dict(num_negatives=2, sample_negatives=True)
    kw.update(global_batch_size=8, tokenizer=tok, seed=5, process_index=0, process_count=1)
    ours = list(ttext.StreamingShardDataset(spec, state_dir=str(tmp_path / "s_port"), **kw))
    theirs = list(jtext.StreamingShardDataset(spec, state_dir=str(tmp_path / "s_jax"), **kw))
    assert_same_batches(ours, theirs)
    if kind == "triplet_kd":
        assert ours[0]["kd_scores"].shape == (8, 3)


def test_bucket_index_matches_jax(tmp_path):
    make_bucket(tmp_path)
    bucket = tmp_path / "data" / "pairs"
    j_counts = j_build_bucket_index(str(bucket))
    with gzip.open(bucket / "offsets.json.gz", "rt") as f:
        j_offsets = json.load(f)
    assert build_bucket_index(str(bucket)) == j_counts
    with gzip.open(bucket / "offsets.json.gz", "rt") as f:
        assert json.load(f) == j_offsets


@pytest.mark.parametrize("consumed_by_trainer", [False, True])
def test_streaming_resume_gives_the_next_batch(tmp_path, consumed_by_trainer):
    tok = make_tokenizer(tmp_path)
    spec = make_bucket(tmp_path)

    def fresh(name):
        return ttext.StreamingShardDataset(spec, global_batch_size=8, tokenizer=tok, seed=7,
                                           sample_negatives=True, state_dir=str(tmp_path / name))

    whole = list(fresh("whole"))
    ds = fresh("first")
    it = iter(ds)
    seen = [next(it) for _ in range(5 if consumed_by_trainer else 3)]
    if consumed_by_trainer:  # a prefetch thread read two batches ahead
        ds.note_consumed(seen[2]["cursor_snapshot"])
    ds.save_state(str(tmp_path / "ckpt"))
    resumed = fresh("second")
    resumed.load_state(str(tmp_path / "ckpt"))
    assert_same_batches(list(resumed), whole[3:])


@pytest.mark.parametrize("next_batch", [2, 5])
def test_local_jsonl_resume_gives_the_next_batch(tmp_path, next_batch):
    """The port's local cursor (JAX's local dataset has none): mid-epoch and
    at the epoch's end, where the next epoch's shuffle follows."""
    tok = make_tokenizer(tmp_path)
    path = _records(tmp_path / "train.jsonl", triplet=True)
    kw = dict(global_batch_size=8, tokenizer=tok, seed=3, add_eos=False, num_negatives=2,
              sample_negatives=True, objective={"type": "triplet", "columns": ["query", "document", "negatives"]})
    ds = ttext.LocalJsonlDataset([path], **kw)
    whole = list(ds) + list(ds)
    ds = ttext.LocalJsonlDataset([path], **kw)
    first = list(ds)[:next_batch]
    ds.note_consumed(first[-1]["cursor_snapshot"])
    ds.save_state(str(tmp_path / "ckpt"))
    resumed = ttext.LocalJsonlDataset([path], **kw)
    resumed.load_state(str(tmp_path / "ckpt"))
    assert_same_batches(list(resumed) + list(resumed), whole[next_batch:])


def test_pair_extraction_and_collator_checks_match_jax(tmp_path):
    objective = {"type": "triplet", "columns": ["query", "document", "negatives"]}
    for num_negatives in (0, 1, 3, 5, -1):
        record = {"query": "q", "document": "pos", "negatives": ["n0", "n1", "n2"]}
        ours = ttext._extract_pair(record, objective, num_negatives, True, random.Random(0))
        assert ours == jtext._extract_pair(record, objective, num_negatives, True, random.Random(0))
    for side in (ttext, jtext):
        with pytest.raises(ValueError, match="no negatives"):
            side._extract_pair({"query": "q", "document": "p", "negatives": []}, objective, 2, True,
                               random.Random(0))
        with pytest.raises(ValueError, match="do not end in EOS"):
            side.validate_eos_placement(np.array([[5, 6, 0]]), np.array([[1, 1, 0]]), eos_id=7)
    assert ttext.expand_urls("a-{08..11}.gz") == jtext.expand_urls("a-{08..11}.gz")


def test_stub_tokenizer_collates_like_a_tokenizer_without_eos():
    tok = StubTokenizer(1000)
    collator = ttext.TokenizeCollator(tok, add_eos=True, add_prefix=True,
                                      col_max_length={"query": 6, "document": 10})
    assert not collator.add_eos  # no EOS token: nothing appended or pinned
    out = collator([{"query": "1 2 3", "document": "4 5 6 7 8 9 10 11 12 13 14"},
                    {"query": "a", "document": "b c"}], "paired", dataset_name="synthetic")
    assert out["dataset_name"] == "synthetic"
    np.testing.assert_array_equal(out["query_input_ids"][0], [101, tok._ids("query:", 9)[1], 1, 2, 3, 0])
    np.testing.assert_array_equal(out["query_attention_mask"], [[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0]])
    assert out["document_input_ids"].shape == (2, 10) and out["document_input_ids"].dtype == np.int32
    assert out["document_attention_mask"][0].all() and out["document_attention_mask"][1].sum() == 4
