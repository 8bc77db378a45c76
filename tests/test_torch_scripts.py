"""The port's serving and mining scripts against JAX's.

- The encode CLI: the port's `.npy` against JAX's CLI on the tiny BERT
  checkpoint and one input file, both in bf16 as JAX's CLI hard-codes it
  (cosine >= 0.999 per row); with --binarize (and --matryoshka_dim) the
  packed bytes equal JAX's with both sides in fp32 (a test-local wrap of
  JAX's `load_biencoder`), where no sign sits within rounding of 0;
  `encode_texts` over a loaded model equals what `main` writes.
- `mine` and `consistency_keep_mask` against JAX's on the same embeddings:
  identical lists and masks, also where scores tie (ties go to the lower
  index on both sides), and the two CLIs end to end against JAX's. The
  filter compares each positive's score (a numpy einsum) with the pool's
  scores (a matrix product), its own included, on both sides; in floats
  that self-comparison is decided by rounding, so its comparison runs on
  integer-valued embeddings, whose every product is exact in fp32.
"""

import json
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from contrastors_tpu.scripts.consistency_filter import consistency_keep_mask as j_keep
from contrastors_tpu.scripts.mine_hard_negatives import mine as j_mine
from contrastors_tpu_torch.scripts.consistency_filter import consistency_keep_mask
from contrastors_tpu_torch.scripts.mine_hard_negatives import mine

from test_trainer_e2e import make_checkpoint_dir


@pytest.fixture(scope="module")
def ckpt_and_texts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripts")
    ckpt = make_checkpoint_dir(tmp)
    rng = np.random.default_rng(0)
    texts = [" ".join(f"word{x}" for x in rng.integers(0, 100, size=n)) for n in rng.integers(1, 14, size=11)]
    path = tmp / "texts.txt"
    path.write_text("\n".join(texts) + "\n")
    jsonl = tmp / "texts.jsonl"
    jsonl.write_text("".join(json.dumps({"body": t}) + "\n" for t in texts))
    return tmp, ckpt, str(path), str(jsonl), texts


def jax_cli(monkeypatch, module, args, fp32=False):
    """Run one of JAX's argv-reading CLIs, in fp32 when asked."""
    import contrastors_tpu.models.auto as j_auto

    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["prog"] + args)
        if fp32:
            j_load = j_auto.load_biencoder
            m.setattr(j_auto, "load_biencoder", lambda margs, dtype=None, **kw: j_load(margs, dtype=jnp.float32,
                                                                                          **kw))
        module.main()


def test_encode_cli_matches_jax_in_bf16(ckpt_and_texts, monkeypatch):
    from contrastors_tpu.scripts import encode as j_encode
    from contrastors_tpu_torch.scripts import encode

    tmp, ckpt, path, jsonl, texts = ckpt_and_texts
    common = ["--model_name", ckpt, "--input", path, "--seq_len", "16", "--batch_size", "4",
              "--prefix", "search_document"]
    jax_cli(monkeypatch, j_encode, common + ["--output", str(tmp / "jax.npy")])
    encode.main(common + ["--output", str(tmp / "port.npy"), "--device", "cpu"])
    want, got = np.load(tmp / "jax.npy"), np.load(tmp / "port.npy")
    assert got.shape == want.shape == (len(texts), 64) and got.dtype == np.float32
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    # a jsonl column reads the same texts
    encode.main(["--model_name", ckpt, "--input", jsonl, "--column", "body", "--seq_len", "16", "--batch_size",
                 "4", "--prefix", "search_document", "--output", str(tmp / "port_jsonl.npy"), "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp / "port_jsonl.npy"), got)


@pytest.mark.parametrize("extra", [[], ["--matryoshka_dim", "24"]], ids=["all_dims", "matryoshka_24"])
def test_encode_cli_binarized_bytes_equal_jax(ckpt_and_texts, monkeypatch, extra):
    from contrastors_tpu.scripts import encode as j_encode
    from contrastors_tpu_torch.eval.encoder import auto_tokenizer, load_encoder_model
    from contrastors_tpu_torch.scripts import encode

    tmp, ckpt, path, _, texts = ckpt_and_texts
    common = ["--model_name", ckpt, "--input", path, "--seq_len", "16", "--batch_size", "4", "--binarize"] + extra
    name = "_".join(extra) or "all"
    jax_cli(monkeypatch, j_encode, common + ["--output", str(tmp / f"jax_bits_{name}.npy")], fp32=True)
    got = encode.main(common + ["--output", str(tmp / f"port_bits_{name}.npy"), "--device", "cpu", "--dtype", "fp32"])
    want = np.load(tmp / f"jax_bits_{name}.npy")
    dims = int(extra[1]) if extra else 64
    assert got.dtype == want.dtype == np.uint8 and got.shape == (len(texts), dims // 8)
    np.testing.assert_array_equal(got, want)
    # the packed signs of the float embeddings' first dims
    module, _ = load_encoder_model(ckpt, dtype="fp32", device="cpu")
    floats = encode.encode_texts(module, auto_tokenizer(ckpt), texts, seq_len=16, batch_size=4)
    np.testing.assert_array_equal(np.packbits(floats[:, :dims] > 0, axis=-1), got)


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def embeddings(seed, n=48, d=16, ties=False):
    rng = np.random.default_rng(seed)
    docs = _norm(rng.normal(size=(n, d))).astype(np.float32)
    if ties:  # a few distinct documents repeated: many equal scores
        docs = docs[rng.integers(0, 6, size=n)]
    queries = _norm(docs + 0.3 * rng.normal(size=docs.shape)).astype(np.float32)
    # near-duplicates of the next document: false negatives to filter
    docs[1::4] = _norm(docs[0::4] + 0.001 * rng.normal(size=docs[0::4].shape)).astype(np.float32)
    return queries, docs


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied_scores"])
def test_mine_equals_jax(ties):
    q, d = embeddings(1, ties=ties)
    for num, margin, chunk in ((3, 0.95, 1024), (7, 0.95, 10), (5, 0.5, 7)):
        got = mine(q, d, np.arange(len(q)), num_negatives=num, margin=margin, chunk=chunk, device="cpu")
        want = j_mine(q, d, np.arange(len(q)), num_negatives=num, margin=margin, chunk=chunk)
        assert got == want
        assert all(i not in negs for i, negs in enumerate(got))


def integer_embeddings(seed, n=64, d=16):
    """Small integers: every dot product exact in fp32, in any order."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    queries = docs + rng.integers(-1, 2, size=(n, d)).astype(np.float32)
    docs[1::4] = docs[0::4]
    docs[1::4, 0] += 1  # near-duplicates
    return queries, docs


@pytest.mark.parametrize("pool_size", [0, 20], ids=["all", "pool20"])
def test_consistency_keep_mask_equals_jax(pool_size):
    q, d = integer_embeddings(2)
    q[:6] = d[np.arange(6) + 30]  # six queries aligned with another document
    for top_k, chunk in ((2, 1024), (1, 9)):
        got = consistency_keep_mask(q, d, top_k=top_k, pool_size=pool_size, seed=3, chunk=chunk, device="cpu")
        want = j_keep(q, d, top_k=top_k, pool_size=pool_size, seed=3, chunk=chunk)
        np.testing.assert_array_equal(got, want)
    assert not consistency_keep_mask(q, d, device="cpu")[:6].any()


def test_mining_clis_equal_jax(ckpt_and_texts, monkeypatch):
    from contrastors_tpu.scripts import consistency_filter as j_cf
    from contrastors_tpu.scripts import mine_hard_negatives as j_mh
    from contrastors_tpu_torch.scripts import consistency_filter as cf
    from contrastors_tpu_torch.scripts import mine_hard_negatives as mh

    tmp, ckpt, _, _, _ = ckpt_and_texts
    rng = np.random.default_rng(4)
    pairs = tmp / "pairs.jsonl"
    with open(pairs, "w") as f:
        for _ in range(24):
            w = rng.integers(0, 100, size=6)
            f.write(json.dumps({"query": " ".join(f"word{x}" for x in w[:3]),
                                "document": " ".join(f"word{x}" for x in w)}) + "\n")
    for j_mod, mod, flags in ((j_mh, mh, ["--num_negatives", "3"]), (j_cf, cf, ["--top_k", "3"])):
        common = ["--pairs", str(pairs), "--model", ckpt, "--seq_len", "16", "--batch_size", "8"] + flags
        name = mod.__name__.rsplit(".", 1)[-1]
        jax_cli(monkeypatch, j_mod, common + ["--output", str(tmp / f"jax_{name}.jsonl")])
        mod.main(common + ["--output", str(tmp / f"port_{name}.jsonl"), "--device", "cpu"])
        with open(tmp / f"jax_{name}.jsonl") as f, open(tmp / f"port_{name}.jsonl") as g:
            want, got = f.read(), g.read()
        assert got == want and got
