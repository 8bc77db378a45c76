"""The port's DataComp suite (`contrastors_tpu_torch/eval/datacomp.py`)
against the JAX package's, on the CPU.

Both sides get the same locally built webdataset shards and the same
encode callables (tests/test_image_text.py's toy encoders, and an oracle
for WinoGAViL), so every metric is a function of the shards' decoding and
the task code: the results must be equal (atol 1e-12). Held:
  - zero-shot, grouped (fairness / WILDS) zero-shot, WinoGAViL (from
    instances and from a tar of candidate images) and retrieval, each
    against JAX's (tests/test_image_text.py:216,329,376);
  - `aggregate` and `datacomp_aggregate_scores`, the bundled task list and
    class names (the port's own package data, equal to JAX's), and
    `resolve_classnames`;
  - `run_tasks` (JAX's `main` loop) over a task-list YAML against JAX's
    task functions, and the port's `main` end to end on the CPU from tiny
    HF checkpoints (its text tower's embeddings equal to JAX's within
    1e-5; the vision tower's MAP head is drawn at random on each side).
"""

import io
import json
import tarfile

import numpy as np
import pytest

from contrastors_tpu.eval import datacomp as J
from contrastors_tpu_torch.eval import datacomp as T

from test_image_text import make_tar_shards, make_vision_checkpoint, rand_image
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _jpeg(rng):
    buf = io.BytesIO()
    rand_image(rng).save(buf, format="JPEG")
    return buf.getvalue()


def classification_shard(path, n, seed, group=False):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            _add(tf, f"{i:04d}.jpg", _jpeg(rng))
            meta = {"label": i % 2}
            if group:
                meta["group"] = "africa" if i % 3 == 0 else "europe"
            _add(tf, f"{i:04d}.json", json.dumps(meta).encode())
    return str(path)


def wino_shard(path, seed):
    """Instances <key>.json {cue, associations} with candidates <key>.<i>.jpg."""
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for k, (size, n_assoc) in enumerate(((5, 2), (6, 3), (10, 4))):
            mask = np.zeros(size, bool)
            mask[rng.choice(size, n_assoc, replace=False)] = True
            for i in range(size):
                _add(tf, f"inst{k}.{i}.jpg", _jpeg(rng))
            _add(tf, f"inst{k}.json", json.dumps({"cue": f"cue{k}", "associations": mask.tolist()}).encode())
    return str(path)


def encode_image(px):
    flat = px.reshape(px.shape[0], -1)[:, :16]
    return flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-6)


def encode_text(texts):
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        out[i, hash(t) % 16] = 1.0
    return out


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-12, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("datacomp")
    return dict(cls=classification_shard(tmp / "cls-0000.tar", 8, 0),
                grp=classification_shard(tmp / "grp-0000.tar", 12, 3, group=True),
                wino=wino_shard(tmp / "wino-0000.tar", 7),
                ret=make_tar_shards(tmp, n_shards=2, per_shard=12), tmp=tmp)


def test_classification_samples_and_zeroshot_match_jax(shards):
    got, want = (list(m.iter_wds_classification(shards["cls"], image_size=32)) for m in (T, J))
    assert len(got) == len(want) == 8
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gl == wl and np.array_equal(gi, wi)
    res = [m.zeroshot_classification_task(encode_image, encode_text, shards["cls"], ["cat", "dog"], image_size=32,
                                          batch_size=3) for m in (T, J)]
    assert_same(*res)
    assert res[0]["acc5"] == 1.0
    # the same samples decoded beforehand (a host without Pillow)
    assert_same(T.zeroshot_classification_task(encode_image, encode_text, None, ["cat", "dog"], batch_size=3,
                                               samples=got), res[1])


def test_grouped_zeroshot_matches_jax(shards):
    res = [m.grouped_zeroshot_task(encode_image, encode_text, shards["grp"], ["cat", "dog"], image_size=32,
                                   batch_size=5) for m in (T, J)]
    assert_same(*res)
    decoded = list(T._iter_wds(shards["grp"], 32, group_key="group"))
    assert_same(T.grouped_zeroshot_task(encode_image, encode_text, None, ["cat", "dog"], batch_size=5,
                                        samples=decoded), res[1])
    assert res[0]["worst_group_acc1"] == min(res[0]["acc1_group_africa"], res[0]["acc1_group_europe"])


def test_winogavil_matches_jax(shards):
    assert T.get_clip_prompt("elephant") == J.get_clip_prompt("elephant") == "An elephant"
    assert T.get_clip_prompt("Dog", prefix="classification") == "classification: A dog"
    got, want = (list(m.iter_wds_wino(shards["wino"], 32)) for m in (T, J))
    assert len(got) == len(want) == 3
    for (gi, gc, gm), (wi, wc, wm) in zip(got, want):
        assert gc == wc and np.array_equal(gm, wm) and all(np.array_equal(a, b) for a, b in zip(gi, wi))
    res = [m.winogavil_task(encode_image, encode_text, shards["wino"], image_size=32, prefix="p") for m in (T, J)]
    assert_same(*res)
    # the oracle instances of tests/test_image_text.py: every set recovered
    rng = np.random.default_rng(7)
    instances, truth = [], {}
    for size, n_assoc in ((5, 2), (6, 3), (10, 4), (12, 5)):
        mask = np.zeros(size, bool)
        mask[rng.choice(size, n_assoc, replace=False)] = True
        instances.append(([np.eye(16, dtype=np.float32)[i].reshape(1, 4, 4) for i in range(size)], f"cue{size}",
                          mask))
        truth[f"cue{size}"] = mask

    def oracle_text(texts):
        out = np.zeros((len(texts), 16), np.float32)
        for i, t in enumerate(texts):
            m = truth[t.split()[-1]]
            out[i, :len(m)] = m
        return out

    res = [m.winogavil_task(lambda px: px.reshape(px.shape[0], -1), oracle_text, instances=instances)
           for m in (T, J)]
    assert_same(*res)
    assert res[0]["avg_jaccard_score"] == 1.0 and res[0]["jaccard_score_10-12"] == 1.0


def test_retrieval_matches_jax(shards):
    res = [m.retrieval_task(encode_image, encode_text, shards["ret"], image_size=32, batch_size=5, max_samples=20)
           for m in (T, J)]
    assert_same(*res)
    decoded = list(T.iter_wds_retrieval(shards["ret"], 32))
    assert len(decoded) == 24
    assert_same(T.retrieval_task(encode_image, encode_text, None, batch_size=5, max_samples=20, samples=decoded),
                res[1])
    assert "image_to_text_R@1" in res[0]


def test_aggregates_task_list_and_class_names_match_jax():
    results = {"a": {"acc1": 0.25}, "b": {"image_to_text_R@1": 0.5, "text_to_image_R@1": 0.7},
               "c": {"acc1": 0.5, "worst_group_acc1": 0.1}, "d": {"avg_jaccard_score": 0.3}}
    assert_same(T.aggregate(results), J.aggregate(results))
    assert T.load_datacomp_tasklist() == J.load_datacomp_tasklist()
    assert T.bundled_classnames() == J.bundled_classnames()
    names = sorted(v["name"] for v in T.load_datacomp_tasklist().values())
    scores = {n: (i % 7) / 7 for i, n in enumerate(names)}
    for subset in (scores, {k: v for k, v in scores.items() if k in ("ImageNet 1k", "Flickr", "SVHN", "FairFace")}):
        assert_same(T.datacomp_aggregate_scores(subset), J.datacomp_aggregate_scores(subset))
    with pytest.raises(ValueError, match="unknown DataComp task names"):
        T.datacomp_aggregate_scores({"no such task": 1.0})
    for task in ({"name": "ImageNet 1k"}, {"key": "cifar10"}, {"name": "x", "classnames": ["a", "b"]}):
        assert T.resolve_classnames(task) == J.resolve_classnames(task)
    with pytest.raises(ValueError, match="no classnames given"):
        T.resolve_classnames({"name": "unbundled task"})


def _tasklist(shards):
    import yaml

    tasks = [dict(name="cls", type="zeroshot", shards=shards["cls"], classnames=["cat", "dog"]),
             dict(name="grp", type="fairness", shards=shards["grp"], classnames=["cat", "dog"]),
             dict(name="wino", type="winogavil", shards=shards["wino"]),
             dict(name="ret", type="retrieval", shards=shards["ret"])]
    path = shards["tmp"] / "tasks.yaml"
    path.write_text(yaml.safe_dump({"tasks": tasks}))
    return tasks, str(path)


def test_run_tasks_matches_jax_task_functions(shards):
    tasks, _ = _tasklist(shards)
    got = T.run_tasks(tasks, encode_image, encode_text, image_size=32, log=lambda *a: None)
    want = {
        "cls": J.zeroshot_classification_task(encode_image, encode_text, shards["cls"], ["cat", "dog"], 32),
        "grp": J.grouped_zeroshot_task(encode_image, encode_text, shards["grp"], ["cat", "dog"], image_size=32),
        "wino": J.winogavil_task(encode_image, encode_text, shards["wino"], image_size=32),
        "ret": J.retrieval_task(encode_image, encode_text, shards["ret"], 32),
    }
    want["aggregate"] = J.aggregate(want)
    assert got.keys() == want.keys()
    for k in want:
        assert_same(got[k], want[k])
    with pytest.raises(SystemExit, match="unknown task type"):
        T.run_tasks([dict(name="x", type="nope", shards="")], encode_image, encode_text)


def test_main_runs_on_the_cpu_from_tiny_checkpoints(shards, tmp_path):
    import jax
    import jax.numpy as jnp
    from transformers import AutoTokenizer

    from contrastors_tpu.config import ModelArgs as JModelArgs
    from contrastors_tpu.models.auto import load_biencoder as j_load
    from contrastors_tpu_torch.eval.encoder import auto_tokenizer, load_encoder_model

    text, vision = make_checkpoint_dir(tmp_path), make_vision_checkpoint(tmp_path)
    _, yaml_path = _tasklist(shards)
    out = tmp_path / "results.json"
    results = T.main(["--text_model", text, "--vision_model", vision, "--tasks", yaml_path, "--image_size", "32",
                      "--output", str(out), "--max_length", "32", "--device", "cpu", "--dtype", "fp32"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert set(results) == {"cls", "grp", "wino", "ret", "aggregate"}
    assert set(results["aggregate"]) == {"zeroshot_acc1", "worst_group_acc1", "retrieval_R@1", "winogavil_jaccard"}
    # the text tower: the port's encoder against JAX's main's, in fp32
    module, _ = load_encoder_model(text, pooling="mean", dtype="fp32", device="cpu")
    vis, _ = load_encoder_model(vision, pooling="map", dtype="fp32", device="cpu")
    _, port_text = T.make_encoders(module, vis, auto_tokenizer(text), max_length=32)
    j_mod, j_params, _ = j_load(JModelArgs(model_type="encoder", model_name=text, pooling="mean"),
                                dtype=jnp.float32)
    tok = AutoTokenizer.from_pretrained(text)
    prompts = ["a photo of a cat.", "word3 word4 word5", "An elephant"]
    enc = tok(prompts, padding="max_length", truncation=True, max_length=32, return_tensors="np")
    want = jax.jit(lambda p, i, m: j_mod.apply(p, input_ids=i, attention_mask=m)["embedding"])(
        j_params, jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"]))
    np.testing.assert_allclose(port_text(prompts), np.asarray(want), atol=1e-5, rtol=0)
