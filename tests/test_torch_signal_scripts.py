"""The port's train-to-signal scripts and vision ablation on the CPU:
`contrastors_tpu_torch/scripts/{train_to_signal,vision_train_to_signal,
ablate_vision}.py`.

Held:
  - each world builder writes JAX's files for the same seed, byte for
    byte (the HF checkpoints, tokenizer files, pairs, the BEIR set, the PNG
    tar shards), and the vision world's held-out renders and labels are
    JAX's;
  - without transformers (the card's machine) the checkpoints hold the
    same weights, built by the scripts' mirrors of HF's BertModel / ViTModel
    init (equal to HF's state dicts bit for bit), and a hand-made
    config.json that resolves to the same TrunkConfig as HF's;
  - `data/transforms.py:ArrayImage` resizes and crops as Pillow does, bit
    for bit, and the vision run's in-memory shards give the PNG shards'
    batches through `ImageTextDataset` (shard order, shuffle buffer, random
    resized crop);
  - `VocabTokenizer` over a world's vocab.txt gives `BertTokenizerFast`'s
    ids and masks on every text the runs tokenise (pairs, corpus,
    queries, captions and the zero-shot prompts);
  - a short run of each script on the CPU from the worlds that the card's
    machine builds, whose logged loss falls and whose eval reads before and
    after; the bars' checks pass and fail where they should;
  - ablate_vision at a tiny EVA02: every piece timed, each share the
    piece's step time over the step.
"""

import json
import os
import pathlib

import numpy as np
import pytest

from contrastors_tpu.scripts import train_to_signal as JT
from contrastors_tpu.scripts import vision_train_to_signal as JV
from contrastors_tpu_torch.scripts import ablate_vision as A
from contrastors_tpu_torch.scripts import train_to_signal as TT
from contrastors_tpu_torch.scripts import vision_train_to_signal as TV
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TINY_VIT = dict(n_embd=64, n_layer=2, n_head=4, n_inner=128, img_size=32, patch_size=8, ref_feat_shape=(4, 4))


def assert_same_files(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    for rel in files:
        assert pathlib.Path(a, rel).read_bytes() == pathlib.Path(b, rel).read_bytes(), rel


def _vocab_tokenizer(ckpt):
    from contrastors_tpu_torch.eval.stub_tokenizer import VocabTokenizer

    return VocabTokenizer(pathlib.Path(ckpt, "vocab.txt").read_text().split("\n"))


def _same_tokens(ckpt, texts, max_length):
    from transformers import BertTokenizerFast

    hf = BertTokenizerFast.from_pretrained(ckpt)
    a = hf(texts, padding="max_length", truncation=True, max_length=max_length, return_tensors="np")
    b = _vocab_tokenizer(ckpt)(texts, padding="max_length", truncation=True, max_length=max_length,
                               return_tensors="np")
    for k in ("input_ids", "attention_mask"):
        assert np.array_equal(a[k], b[k]), k


def test_text_world_is_jaxs_and_tokenises_as_hf(tmp_path):
    got = TT.build_world(tmp_path / "port")
    want = JT.build_world(tmp_path / "jax")
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == [os.path.relpath(p, tmp_path / "jax")
                                                                   for p in want]
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    ckpt, pairs, ev = got
    rows = [json.loads(line) for line in open(pairs)]
    assert len(rows) == TT.TOPICS * TT.PAIRS_PER_TOPIC
    texts = [r["query"] for r in rows[:300]] + [r["document"] for r in rows[:300]]
    texts += [json.loads(line)["text"] for name in ("corpus.jsonl", "queries.jsonl")
              for line in open(os.path.join(ev, name))]
    _same_tokens(ckpt, texts, 32)
    _same_tokens(ckpt, texts[:50], 16)


def _trunk_config(ckpt, vision=False):
    from contrastors_tpu_torch.config import ModelArgs
    from contrastors_tpu_torch.models.auto import resolve_trunk_config

    return resolve_trunk_config(ModelArgs(model_type="locked_text" if vision else "encoder", model_name=ckpt,
                                          pooling="mean", attn_impl="sdpa", pretrained=False))[3]


def test_worlds_without_transformers_hold_jaxs_weights(tmp_path):
    import torch
    from transformers import BertConfig, BertModel, ViTConfig, ViTModel

    from contrastors_tpu_torch.models.auto import _load_state_dict

    for vocab, geometry in ((len(TT.SPECIAL + TT.vocab_words()), TT.BERT), (len(TV.text_vocab()), TV.TEXT_BERT)):
        torch.manual_seed(0)
        want = BertModel(BertConfig(vocab_size=vocab, **geometry)).state_dict()
        got = TT.hf_bert_state_dict(vocab, 0, geometry)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    torch.manual_seed(1)
    want = ViTModel(ViTConfig(**TV.VIT), add_pooling_layer=False).state_dict()
    got = TV.hf_vit_state_dict(1)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    full, bare = TT.build_world(tmp_path / "full", weights=True), TT.build_world(tmp_path / "bare", weights=False)
    assert sorted(os.listdir(bare[0])) == ["config.json", "pytorch_model.bin", "vocab.txt"]
    assert _trunk_config(full[0]) == _trunk_config(bare[0])
    assert pathlib.Path(full[1]).read_bytes() == pathlib.Path(bare[1]).read_bytes()
    full_v = TV.build_world(tmp_path / "vfull", 8, weights=True)
    bare_v = TV.build_world(tmp_path / "vbare", 8, weights=False)
    for d_full, d_bare, vision in ((full[0], bare[0], False), (full_v[0], bare_v[0], False),
                                   (full_v[1], bare_v[1], True)):
        assert _trunk_config(d_full, vision) == _trunk_config(d_bare, vision)
        a, b = _load_state_dict(d_full), _load_state_dict(d_bare)  # what the port's loader reads
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_array_image_crops_as_pillow():
    import random

    from PIL import Image

    from contrastors_tpu_torch.data.transforms import BICUBIC, ArrayImage, center_crop_resize, random_resized_crop

    rng = np.random.default_rng(0)
    for trial in range(120):
        h, w = (int(v) for v in rng.integers(8, 60, size=2))
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        box = (x0, y0, int(rng.integers(x0 + 1, w + 1)), int(rng.integers(y0 + 1, h + 1)))
        size = tuple(int(v) for v in rng.integers(4, 70, size=2))
        for b in (box, None):
            assert np.array_equal(np.asarray(ArrayImage(arr).resize(size, BICUBIC, box=b)),
                                  np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC, box=b))), (size, b)
    for arr in rng.integers(0, 256, size=(20, 32, 40, 3), dtype=np.uint8):
        random.seed(3)
        a = np.asarray(random_resized_crop(ArrayImage(arr), 32))
        random.seed(3)
        assert np.array_equal(a, np.asarray(random_resized_crop(Image.fromarray(arr), 32)))
        assert np.array_equal(np.asarray(center_crop_resize(ArrayImage(arr), 24)),
                              np.asarray(center_crop_resize(Image.fromarray(arr), 24)))


def test_vision_memory_shards_give_the_png_shards_batches(tmp_path):
    import random

    from contrastors_tpu_torch.data.image_text import ImageTextDataset
    from contrastors_tpu_torch.eval.stub_tokenizer import VocabTokenizer

    world = TV.sample_world(256)
    text, vision, pattern, _, _ = TV.build_world(tmp_path, 256, world=world)
    tok = VocabTokenizer(TV.text_vocab())
    cfg = TV.run_config(text, vision, pattern, str(tmp_path / "run"), 4, 2e-3)
    random.seed(0)
    got = list(TV.rendered_shards(world[0], world[1], tok, cfg))
    random.seed(0)
    want = list(ImageTextDataset(pattern, global_batch_size=TV.BATCH, tokenizer=tok, image_size=TV.IMG,
                                 seq_len=TV.SEQ_LEN, seed=0, train_num_samples=256, ship_uint8=True))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert got[0]["pixel_values"].dtype == np.uint8 and got[0]["pixel_values"].shape == (TV.BATCH, 3, TV.IMG, TV.IMG)


def test_vision_world_is_jaxs_and_tokenises_as_hf(tmp_path):
    from contrastors_tpu_torch.eval.zero_shot import PROMPT_TEMPLATES

    got = TV.build_world(tmp_path / "port", n_train=32)
    want = JV.build_world(tmp_path / "jax", n_train=32)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert os.path.relpath(got[2], tmp_path / "port") == os.path.relpath(want[2], tmp_path / "jax")
    assert np.array_equal(got[3], want[3]) and np.array_equal(got[4], want[4])
    assert TV.classnames() == JV.classnames() and len(TV.classnames()) == 32
    imgs, caps, _, _ = TV.sample_world(32)
    assert imgs.shape == (32, TV.IMG, TV.IMG, 3) and len(caps) == 32
    prompts = [t.format(c) for c in TV.classnames() for t in PROMPT_TEMPLATES]
    _same_tokens(got[0], prompts + caps, TV.SEQ_LEN)
    assert all(1 not in ids for ids in _vocab_tokenizer(got[0])(prompts)["input_ids"])  # no [UNK]


def test_text_signal_run_learns_without_transformers_files():
    result = TT.run(steps=20, device="cpu", weights=False, log=lambda *a: None)
    assert result["steps"] == 20
    (s0, l0), (s1, l1) = result["loss_curve"][0], result["loss_curve"][-1]
    assert (s0, s1) == (10, 20) and l1 < l0
    assert result["ndcg@10_after"] > result["ndcg@10_init"]
    TT.check({**result, "ndcg@10_after": 0.95})
    with pytest.raises(AssertionError, match="below the learnable-corpus bar"):
        TT.check({**result, "ndcg@10_after": 0.8, "ndcg@10_init": 0.0})
    with pytest.raises(AssertionError, match="did not improve"):
        TT.check({**result, "ndcg@10_after": 0.95, "ndcg@10_init": 0.96})


def test_vision_signal_run_learns_without_transformers_files():
    result = TV.run(steps=40, device="cpu", weights=False, log=lambda *a: None)
    assert result["steps"] == 40 and result["num_classes"] == 32
    (s0, l0), (s1, l1) = result["loss_curve"][0], result["loss_curve"][-1]
    assert (s0, s1) == (20, 40) and l1 < l0
    assert result["zeroshot_top1_after"] > result["zeroshot_top1_init"]
    TV.check({**result, "zeroshot_top1_after": 0.5, "zeroshot_top1_init": 0.03})
    with pytest.raises(AssertionError, match="below the learnable-corpus bar"):
        TV.check({**result, "zeroshot_top1_after": 0.4, "zeroshot_top1_init": 0.03})


def test_ablate_vision_times_every_piece():
    import torch

    r = A.ablate("cpu", chunk=2, batch=4, iters=1, dtype=torch.float32, **TINY_VIT)
    pieces = r["pieces"]
    assert set(pieces) == {"tower", "patch_embedding", "layernorm", "rotary", "attention", "swiglu_post_ln",
                           "block", "map_pooling", "loss", "optimizer"}
    assert r["seq"] == 17 and r["n_layer"] == 2
    assert pieces["layernorm"]["calls"] == pieces["rotary"]["calls"] == 4 and pieces["attention"]["calls"] == 2
    for name, p in pieces.items():
        assert p["step_ms"] > 0 and p["share"] == pytest.approx(p["step_ms"] / r["step_ms"]), name
    assert r["step_ms"] == pytest.approx(pieces["tower"]["step_ms"] + pieces["loss"]["step_ms"]
                                         + pieces["optimizer"]["step_ms"])
