"""The port's image-text (CLIP / LiT) slice against the JAX package, on the
CPU in fp32, at tiny sizes (2 layers, width 64, 32 x 32 images, patch 8).

A module fixture builds what both sides read, as tests/test_image_text.py
builds it: a random tiny HF BERT text checkpoint with its tokenizer, a tiny
HF ViT checkpoint, two tar shards of 24 JPEG images with captions, and an
ImageNet-style class folder. The JAX `ImageTextTrainer` runs once per case
for the module (the 8-device CPU mesh); the port's trainer starts from
JAX's starting parameters (`convert.flax_to_torch` of the dual tree) and
Python's `random` seeded alike, so both read the same batches. Cases:
locked_text and clip, each with the standard step and the grad-cache step
(chunk 2, the loader's uint8 pixels, one direct image chunk; with clip one
direct text chunk too). Tolerances: the 3 logged losses and grad norms
within 1e-4 relative; the trainable parameters within 1e-4 relative L2 of
JAX's after the 3 steps, all together, and each tensor within 1e-3 with
the key biases left out (their exact gradient is 0; AdamW turns rounding
noise there into steps of size lr); under locked_text the text tower bit-identical to
its start; clip_loss_symmetric and the DualEncoder's loss within 1e-5 and
their gradients within 1e-4 relative L2; transforms and the tar pipeline
bit for bit (pixels) and equal (token ids); the zero-shot and Flickr
metrics equal at JAX's starting parameters.
"""

import io
import json
import os
import random
import tarfile

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.data import image_text as j_it
from contrastors_tpu.data import transforms as j_tf
from contrastors_tpu.losses import clip_loss_symmetric as j_clip_sym
from contrastors_tpu.models.biencoder import LogitScale as JLogitScale
from contrastors_tpu.models.dual_encoder import DualEncoder as JDual
from contrastors_tpu.models.hf_interop_timm import timm_name_to_trunk_config as j_timm_cfg
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import OPENAI_IMAGE_MEAN, OPENAI_IMAGE_STD, Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.data import image_text as t_it
from contrastors_tpu_torch.data import transforms as t_tf
from contrastors_tpu_torch.losses import clip_loss_symmetric
from contrastors_tpu_torch.models import DualEncoder, LogitScale
from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY
from contrastors_tpu_torch.trainers.image_text import ImageTextTrainer

from test_data import make_tokenizer
from test_image_text import make_tar_shards, make_vision_checkpoint, rand_image
from test_trainer_e2e import make_checkpoint_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
CASES = {
    "locked": dict(model_type="locked_text"),
    "locked_gc": dict(model_type="locked_text", train=dict(grad_cache=True, chunk_size=2,
                                                           grad_cache_direct_chunks_q=1)),
    "clip": dict(model_type="clip"),
    "clip_gc": dict(model_type="clip", train=dict(grad_cache=True, chunk_size=2, grad_cache_direct_chunks_q=1,
                                                  grad_cache_direct_chunks_d=1)),
}


def _imagenet_folder(path, seed=1):
    rng = np.random.default_rng(seed)
    for cls in ("n01440764", "n01443537"):
        (path / cls).mkdir(parents=True)
        for i in range(3):
            rand_image(rng).save(path / cls / f"{i}.jpg")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("image_text")
    shards = make_tar_shards(tmp)
    return dict(tmp=tmp, text=make_checkpoint_dir(tmp), vision=make_vision_checkpoint(tmp), shards=shards,
                flickr=shards.replace("{0000..0001}", "0000"), imagenet=_imagenet_folder(tmp / "val"))


def raw_config(files, out_dir, case):
    spec = CASES[case]
    mt = spec["model_type"]
    train_args = dict(num_epochs=1, num_train_steps=STEPS, learning_rate=1e-3, weight_decay=0.01, warmup_steps=1,
                      schedule_type="cosine", max_grad_norm=1.0, adam_beta1=0.9, adam_beta2=0.95, log_lr_every=1,
                      log_grads_every=100, wandb=False, output_dir=out_dir)
    train_args.update(spec.get("train", {}))
    return dict(
        train_args=train_args,
        data_args=dict(image_text_shards=files["shards"], batch_size=8, eval_batch_size=8, seed=0, workers=0,
                       shuffle=True, train_num_samples=48, eval_flickr=True, flickr_shards=files["flickr"],
                       imagenet_val_path=files["imagenet"]),
        model_args=dict(model_type=mt),
        text_model_args=dict(model_type=mt, model_name=files["text"], pooling="mean", freeze=mt == "locked_text",
                             hamming=True, pretrained=True, seq_len=12, attn_impl="sdpa"),
        vision_model_args=dict(model_type=mt, model_name=files["vision"], pooling="map", pretrained=True,
                               logit_scale=None, trainable_logit_scale=True, attn_impl="sdpa"),
        transforms=dict(image_size=32),
    )


def read_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(files):
    """{case: (JAX starting params, JAX trainer, JAX metrics, port trainer,
    port starting state, port metrics)}; the locked case also evaluates both
    at the starting parameters."""
    out = {}
    for case in CASES:
        j_out, t_out = str(files["tmp"] / f"jax_{case}"), str(files["tmp"] / f"port_{case}")
        jt = J_REGISTRY[CASES[case]["model_type"]](JConfig(**raw_config(files, j_out, case)), "fp32")
        start = jax.device_get(jt.params)
        pt = TRAINER_REGISTRY[CASES[case]["model_type"]](Config.from_dict(raw_config(files, t_out, case)), "fp32",
                                                          "cpu")
        pt.model.load_state_dict(flax_to_torch(start), strict=True)
        port_start = {k: v.detach().clone() for k, v in pt.model.state_dict().items()}
        evals = (jt.eval_loop(0), pt.eval_loop(0)) if case == "locked" else None
        random.seed(0)
        jt.train()
        random.seed(0)
        pt.train()
        out[case] = dict(start=start, jax=jt, jax_metrics=read_metrics(j_out), port=pt, port_start=port_start,
                         port_metrics=read_metrics(t_out), evals=evals)
    return out


def _train_lines(metrics):
    return [m for m in metrics if "loss" in m]


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)).double(), torch.as_tensor(np.array(b)).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_port_trainer_logs_jax_metrics(case, runs):
    """Losses, grad norms and the logit scale of 3 steps within 1e-4
    relative; the same keys logged."""
    r = runs[case]
    jm, tm = _train_lines(r["jax_metrics"]), _train_lines(r["port_metrics"])
    assert [m["step"] for m in jm] == [m["step"] for m in tm] == list(range(1, STEPS + 1))
    for key in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], rtol=1e-4, err_msg=key)
    assert {k for m in tm for k in m} == {k for m in jm for k in m}
    assert tm[-1]["logit_scale"] != pytest.approx(1 / 0.07, rel=1e-6)  # the scale moves


def _without_key_bias(name, value):
    """A bias with its key slice removed: the key bias shifts every logit of
    a query row alike, so softmax makes its gradient 0 in exact arithmetic,
    and AdamW turns each side's rounding noise there into steps of size lr."""
    if name.endswith("attn.Wqkv.bias"):
        n = value.shape[0] // 3
        return torch.cat([value[:n], value[2 * n:]])
    if name.endswith("attn.Wkv.bias"):
        return value[value.shape[0] // 2:]
    return value


@pytest.mark.parametrize("case", list(CASES))
def test_port_trainer_ends_at_jax_parameters(case, runs):
    """After the 3 steps the trainable parameters, all together, within 1e-4
    relative L2 of JAX's, and each tensor (key biases left out) within
    1e-3; under locked_text every text tensor bit-identical to its start."""
    r = runs[case]
    want = flax_to_torch(jax.device_get(r["jax"].params))
    got = r["port"].model.state_dict()
    frozen = CASES[case]["model_type"] == "locked_text"
    moved, far, names = 0.0, {}, []
    for name, value in got.items():
        if frozen and name.startswith("text."):
            assert torch.equal(value, r["port_start"][name]), name
            continue
        names.append(name)
        a, b = _without_key_bias(name, value), _without_key_bias(name, want[name])
        if _rel(a, b) > 1e-3:
            far[name] = _rel(a, b)
        moved = max(moved, float((value - r["port_start"][name]).abs().max()))
    assert not far, far
    assert _rel(torch.cat([got[n].flatten() for n in names]), torch.cat([want[n].flatten() for n in names])) <= 1e-4
    assert moved > 1e-4
    trainable = {n for n, p in r["port"].model.named_parameters() if p.requires_grad}
    assert any(n.startswith("text.") for n in trainable) != frozen
    assert "logit_scale.logit_scale" in trainable


def test_eval_metrics_match_jax(runs):
    """The ImageNet zero-shot eval (1000 classes x 8 prompts, a 2-class
    folder at 224 x 224, so the 4 x 4 position grid is resized to 28 x 28)
    and the Flickr retrieval recall, at JAX's starting parameters."""
    j_eval, t_eval = runs["locked"]["evals"]
    assert set(t_eval) == set(j_eval)
    assert {"imagenet_zeroshot_top1", "imagenet_zeroshot_top5", "flickr/image_to_text_R@1"} <= set(t_eval)
    for k in j_eval:
        assert t_eval[k] == pytest.approx(j_eval[k], abs=1e-12), k


def test_clip_loss_symmetric_and_its_gradients_match_jax():
    rng = np.random.default_rng(0)
    img, txt = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    js = JLogitScale(logit_scale_init=20.0)
    sp = js.init(jax.random.PRNGKey(0), jnp.ones(()))

    def jloss(i, t, p):
        return j_clip_sym(i, t, lambda x: js.apply(p, x))

    ref, (gi, gt, gp) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(img), jnp.asarray(txt), sp)
    scale = LogitScale(20.0, device="cpu")
    i_t, t_t = torch.from_numpy(img).requires_grad_(), torch.from_numpy(txt).requires_grad_()
    loss = clip_loss_symmetric(i_t, t_t, scale)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5
    assert _rel(i_t.grad, np.asarray(gi)) <= 1e-4 and _rel(t_t.grad, np.asarray(gt)) <= 1e-4
    assert _rel(scale.logit_scale.grad, np.asarray(gp["params"]["logit_scale"])) <= 1e-4


def _dual_configs(jax_side):
    text = (j_preset if jax_side else t_preset)(n_layer=2, n_embd=64, n_head=4, n_inner=128, vocab_size=128,
                                                 attn_impl="sdpa" if jax_side else "flash")
    vision = (j_timm_cfg if jax_side else timm_name_to_trunk_config)(
        "vit_eva02_base_patch16_224", n_embd=64, n_layer=2, n_head=4, n_inner=128, img_size=32, patch_size=8,
        ref_feat_shape=(4, 4), attn_impl="sdpa" if jax_side else "flash")
    return text, vision


@pytest.mark.parametrize("freeze", [True, False])
def test_dual_encoder_loss_and_gradients_match_jax(freeze):
    """The DualEncoder's symmetric loss within 1e-5 and every gradient within
    1e-4 relative L2; a frozen text tower gets no gradient (JAX's is 0), so
    the global gradient norms agree."""
    rng = np.random.default_rng(1)
    ids = rng.integers(5, 128, size=(4, 12))
    mask = (np.arange(12)[None] < np.array([12, 9, 5, 7])[:, None]).astype(np.int64)
    px = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    jt, jv = _dual_configs(True)
    jm = JDual(text_config=jt, vision_config=jv, freeze_text=freeze, text_hamming=True)
    batch = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px))
    params = jm.init(jax.random.PRNGKey(0), **batch)
    ref, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.apply(p, **batch)["loss"]))(params)
    tt, tv = _dual_configs(False)
    tm = DualEncoder(tt, tv, freeze_text=freeze, text_hamming=True, device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    loss = tm(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(px))["loss"]
    loss.backward()
    assert abs(float(loss) - float(ref)) <= 1e-5
    want = flax_to_torch(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        if freeze and name.startswith("text."):
            assert p.grad is None and float(want[name].abs().max()) == 0.0, name
            continue
        assert _rel(p.grad, want[name]) <= 1e-4, (name, _rel(p.grad, want[name]))
    j_norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(jgrads))))
    t_norm = float(torch.sqrt(sum(p.grad.double().square().sum() for p in tm.parameters() if p.grad is not None)))
    assert t_norm == pytest.approx(j_norm, rel=1e-5)


def _jpegs(n=6, seed=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        arr = rng.integers(0, 255, size=(40 + 7 * i, 56 - 3 * i, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, format="JPEG")
        out.append(Image.open(io.BytesIO(buf.getvalue())))
    return out


@pytest.mark.parametrize("kw", [dict(), dict(is_train=True, seed=5), dict(resize_longest_max=True, fill_color=7),
                                dict(ship_uint8=True), dict(is_train=True, seed=5, ship_uint8=True)])
def test_transforms_are_jax_bit_for_bit(kw):
    """Center crop, random resized crop, the letterbox; fp32 and uint8 CHW."""
    for size in (32, 24):
        jf, tf = j_tf.image_transform(size, **kw), t_tf.image_transform(size, **kw)
        for img in _jpegs():
            a, b = jf(img), tf(img)
            assert a.dtype == b.dtype and a.shape == b.shape == (3, size, size)
            assert np.array_equal(a, b)


def test_device_normalisation_of_uint8_pixels_is_the_hosts_bit_for_bit(files):
    """uint8 pixels normalised by the trainer (fp32 on the device, then the
    compute dtype) equal the host's fp32 pipeline bit for bit."""
    imgs = _jpegs()
    u8 = np.stack([t_tf.image_transform(32, ship_uint8=True)(im) for im in imgs])
    f32 = np.stack([t_tf.image_transform(32)(im) for im in imgs])
    trainer = ImageTextTrainer.__new__(ImageTextTrainer)
    trainer.config = Config.from_dict(raw_config(files, str(files["tmp"] / "unused"), "locked"))
    trainer.dtype = torch.float32
    assert np.array_equal(trainer.pixels(torch.from_numpy(u8)).numpy(), f32)
    mean, std = (np.asarray(x, np.float32).reshape(1, 3, 1, 1) for x in (OPENAI_IMAGE_MEAN, OPENAI_IMAGE_STD))
    assert np.array_equal((u8.astype(np.float32) / 255.0 - mean) / std, f32)


@pytest.mark.parametrize("kw", [dict(), dict(ship_uint8=True), dict(mlm_prob=0.5, shuffle_buffer=0),
                                dict(is_train=False, shuffle_buffer=0)])
def test_tar_pipeline_is_jax_bit_for_bit(files, kw):
    """The same shards through both pipelines: the same batches, pixels bit
    for bit, token ids (and the caption-MLM view) equal."""
    tok = make_tokenizer(files["tmp"])
    args = dict(global_batch_size=8, tokenizer=tok, image_size=32, seq_len=12, train_num_samples=32,
                shuffle_buffer=16)
    args.update(kw)
    batches = []
    for mod in (j_it, t_it):
        random.seed(7)
        batches.append(list(mod.ImageTextDataset(files["shards"], **args)))
    assert len(batches[0]) == len(batches[1]) == 4
    for a, b in zip(*batches):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    j_img = list(j_it.get_imagenet(files["imagenet"], image_size=32, batch_size=4))
    t_img = list(t_it.get_imagenet(files["imagenet"], image_size=32, batch_size=4))
    assert len(j_img) == len(t_img) == 2
    for a, b in zip(j_img, t_img):
        assert all(np.array_equal(a[k], b[k]) for k in ("pixel_values", "labels"))


def test_tar_samples_carry_precomputed_text_embeddings(tmp_path):
    path = tmp_path / "pre.tar"
    rng = np.random.default_rng(0)
    with tarfile.open(path, "w") as tf:
        for i in range(3):
            for name, data in ((f"{i:06d}.jpg", _jpeg_bytes(rng)), (f"{i:06d}.npy", _npy_bytes(i))):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    samples = list(t_it.iter_tar_samples(str(path)))
    assert len(samples) == 3 and all("text_embedding" in s and "image" in s for s in samples)


def _jpeg_bytes(rng):
    buf = io.BytesIO()
    rand_image(rng).save(buf, format="JPEG")
    return buf.getvalue()


def _npy_bytes(i):
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(i).standard_normal(8).astype(np.float32))
    return buf.getvalue()


def test_tower_load_is_strict_and_a_text_projection_is_refused(files, tmp_path):
    """The trainer loads each tower into the DualEncoder strictly, as JAX's
    `_overlay_tower` overlays it: JAX's DualEncoder has no text projection,
    so a text projection_dim is refused on both sides."""
    raw = raw_config(files, str(tmp_path / "proj"), "locked")
    raw["text_model_args"]["projection_dim"] = 32
    with pytest.raises(ValueError, match="dropped"):
        J_REGISTRY["locked_text"](JConfig(**raw), "fp32")
    with pytest.raises(RuntimeError, match="Unexpected key.*proj"):
        TRAINER_REGISTRY["locked_text"](Config.from_dict(raw), "fp32", "cpu")


def test_vision_tower_export_loads_back(runs, tmp_path):
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.model_config import TrunkConfig

    trainer = runs["locked"]["port"]
    path = trainer.save_vision_tower(str(tmp_path))
    with open(os.path.join(path, "trunk_config.json")) as f:
        cfg = TrunkConfig.from_json(f.read())
    tower = BiEncoder(cfg, trunk_type="vision", pooling="map", device="cpu")
    tower.load_state_dict(torch.load(os.path.join(path, "state.pt"), weights_only=True)["model"], strict=True)
    px = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        trainer.dual.eval()
        assert torch.equal(tower.eval()(pixel_values=px)["embedding"], trainer.dual.encode_image(px))


def test_vision_recipe_runs_through_the_cli(files, tmp_path):
    """configs/train/nomic_embed_vision_v1.5.yaml through the port's CLI on
    the CPU, with small overrides (the local tiny towers and data, 2 steps,
    the eval at step 2): locked_text, MAP pooling, hamming, remat, the
    frozen text tower unchanged, the eval logged."""
    with open(os.path.join(ROOT, "configs", "train", "nomic_embed_vision_v1.5.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["text_model_args"].update(model_name=files["text"], seq_len=12)  # the tiny BERT has 64 positions
    raw["vision_model_args"].update(model_name=files["vision"])
    raw["data_args"].update(image_text_shards=files["shards"], batch_size=8, eval_batch_size=8,
                            imagenet_val_path=files["imagenet"])
    raw["train_args"].update(num_train_steps=2, eval_steps=2, log_lr_every=1, warmup_steps=1,
                             output_dir=str(tmp_path / "run"))
    raw["transforms"].update(image_size=32)
    path = tmp_path / "vision.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = ttrain.main(["--config", str(path), "--device", "cpu", "--dtype", "fp32"])
    assert type(trainer) is ImageTextTrainer and trainer.step == 2
    assert trainer.dual.vision.trunk.remat and trainer.dual.vision.pooling == "map"
    assert trainer.dual.text.freeze and trainer.dual.text.hamming is not None
    metrics = read_metrics(tmp_path / "run")
    assert all(np.isfinite(m["loss"]) for m in metrics if "loss" in m)
    assert any("imagenet_zeroshot_top1" in m for m in metrics)
    assert all(not p.requires_grad for p in trainer.dual.text.parameters())
