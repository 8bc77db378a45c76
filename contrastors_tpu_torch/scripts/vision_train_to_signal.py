"""Vision train-to-signal: the LiT trainer LEARNS, not only descends.
Counterpart of `contrastors_tpu/scripts/vision_train_to_signal.py`.

A zero-leakage image-attribute corpus (the same world, draw for draw, as
JAX's): colours x shapes rendered on the host, a caption drawn from the
zero-shot prompt ensemble over the class name. The text tower is frozen at
random init, so each class's prompt embedding is a fixed arbitrary
direction and chance top-1 is 1 / 32; the vision tower must learn, from
(image, caption) pairs alone, to map each rendered attribute pair onto its
class's direction. The LiT recipe's shape (frozen text tower, cosine
schedule, trainable logit scale, grad cache at chunk 16) trains through the
port's `ImageTextTrainer` for a few hundred steps, and the zero-shot eval
of `eval/zero_shot.py` (prompt-ensemble weights from the frozen tower,
top-1 / top-5 over held-out renders) runs before and after. JAX's bars hold
the result: top-1 after training above its value at init, and at least 0.5.

`sample_world` draws the renders, captions and held-out set; `build_world`
writes JAX's files from them: the two tiny checkpoints (JAX's HF files where
`transformers` and `safetensors` import; else config.json and the same
weights, built without transformers, as pytorch_model.bin) and, where
Pillow imports, the PNG tar shards. The run starts from those weights, as
JAX's does. The run reads the renders through the trainer's own loader
(`data/image_text.py:ImageTextDataset`: JAX's shard order, shuffle buffer,
random resized crop and uint8 batches), over the four shards held in
memory (`RenderedShards`, images as `data/transforms.py:ArrayImage`, whose
resize is Pillow's, bit for bit), so that it needs no Pillow and gives the
batches the PNG shards give; text goes through
`eval/stub_tokenizer.py:VocabTokenizer` over the text vocab, which gives
`BertTokenizerFast`'s ids there. Both towers have head dim 16, so their
attention runs the plain `sdpa` (`attn_impl: sdpa`), as JAX's does.

  python -m contrastors_tpu_torch.scripts.vision_train_to_signal \\
      [--out result.json] [--steps 400] [--device cuda]

prints its result as JSON (the loss curve too) and writes it where --out
is given.
"""

import argparse
import io
import json
import os
import pathlib
import random
import shutil
import tarfile
import tempfile

import numpy as np

from contrastors_tpu_torch.eval.zero_shot import PROMPT_TEMPLATES
from contrastors_tpu_torch.scripts.train_to_signal import SPECIAL, hf_available, hf_initialise, write_bert

COLORS = {
    "red": (220, 40, 40),
    "green": (40, 200, 40),
    "blue": (50, 70, 230),
    "yellow": (230, 220, 40),
    "purple": (160, 40, 200),
    "cyan": (40, 210, 210),
    "orange": (240, 140, 30),
    "white": (235, 235, 235),
}
SHAPES = ("square", "circle", "triangle", "cross")
IMG = 32
BATCH = 64
SEQ_LEN = 16
# the zero_shot prompt-ensemble vocabulary (PROMPT_TEMPLATES words), so that
# the frozen tokenizer maps every prompt to known ids
TEMPLATE_WORDS = [
    "itap", "of", "a", "bad", "the", "origami", "photo", "large", "in",
    "video", "game", "art", "small", ".",
]
TEXT_BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=32, type_vocab_size=2, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, image_size=IMG,
           patch_size=8, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def classnames():
    return [f"{c} {s}" for c in COLORS for s in SHAPES]


def text_vocab():
    return SPECIAL + TEMPLATE_WORDS + list(COLORS) + list(SHAPES)


def render(color_rgb, shape, rng):
    """One IMG x IMG attribute image: the shape in its colour over grey
    noise, with position and size jitter so that the task is not a pixel
    lookup."""
    img = rng.integers(40, 90, size=(IMG, IMG, 3)).astype(np.uint8)
    half = int(rng.integers(8, 12))
    cy, cx = (int(rng.integers(half, IMG - half)) for _ in range(2))
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    dy, dx = yy - cy, xx - cx
    if shape == "square":
        m = (np.abs(dy) <= half) & (np.abs(dx) <= half)
    elif shape == "circle":
        m = dy * dy + dx * dx <= half * half
    elif shape == "triangle":
        m = (dy >= -half) & (dy <= half) & (np.abs(dx) <= (dy + half) / 2)
    else:  # cross
        w = max(2, half // 3)
        m = ((np.abs(dy) <= w) & (np.abs(dx) <= half)) | ((np.abs(dx) <= w) & (np.abs(dy) <= half))
    img[m] = np.asarray(color_rgb, np.uint8)
    return img


def sample_world(n_train: int, seed: int = 0):
    """(train renders uint8 [n, IMG, IMG, 3], their captions, held-out
    renders [8 * 32, IMG, IMG, 3], their labels), drawn in JAX's order: four
    shards of ceil(n_train / 4), each sample its class, its render, its
    caption's template; then 8 fresh renders a class from seed + 1."""
    rng = np.random.default_rng(seed)
    names = classnames()
    imgs, caps = [], []
    for _ in range(4 * ((n_train + 3) // 4)):
        ci = int(rng.integers(len(names)))
        color, shape = names[ci].split()
        imgs.append(render(COLORS[color], shape, rng))
        caps.append(PROMPT_TEMPLATES[int(rng.integers(len(PROMPT_TEMPLATES)))].format(names[ci]))
    ev_rng = np.random.default_rng(seed + 1)
    ev_imgs, ev_labels = [], []
    for ci, name in enumerate(names):
        color, shape = name.split()
        for _ in range(8):
            ev_imgs.append(render(COLORS[color], shape, ev_rng))
            ev_labels.append(ci)
    return np.stack(imgs), caps, np.stack(ev_imgs), np.asarray(ev_labels)


def hf_vit_state_dict(seed: int) -> dict:
    """The state dict of transformers' `ViTModel(ViTConfig(**VIT),
    add_pooling_layer=False)` built at torch.manual_seed(seed), without
    transformers: the same parameters drawn in the same order (the cls
    token, the patch conv's default init, the position table, each layer's
    modules), then ViTPreTrainedModel._init_weights applied children first
    (transformers 4.57; the tests hold it equal to HF's bit for bit)."""
    import torch
    from torch import nn

    H, n_int, P = VIT["hidden_size"], VIT["intermediate_size"], VIT["patch_size"]

    def holder(**children):
        m = nn.Module()
        for k, v in children.items():
            setattr(m, k, v)
        return m

    class Embeddings(nn.Module):
        def __init__(self):
            super().__init__()
            self.cls_token = nn.Parameter(torch.randn(1, 1, H))
            self.patch_embeddings = holder(projection=nn.Conv2d(3, H, kernel_size=P, stride=P))
            self.position_embeddings = nn.Parameter(torch.randn(1, (IMG // P) ** 2 + 1, H))

    torch.manual_seed(seed)
    embeddings = Embeddings()
    layers = nn.ModuleList()
    for _ in range(VIT["num_hidden_layers"]):
        attention = holder(attention=holder(query=nn.Linear(H, H), key=nn.Linear(H, H), value=nn.Linear(H, H)),
                           output=holder(dense=nn.Linear(H, H)))
        layers.append(holder(attention=attention, intermediate=holder(dense=nn.Linear(H, n_int)),
                             output=holder(dense=nn.Linear(n_int, H)), layernorm_before=nn.LayerNorm(H, eps=1e-12),
                             layernorm_after=nn.LayerNorm(H, eps=1e-12)))
    model = holder(embeddings=embeddings, encoder=holder(layer=layers), layernorm=nn.LayerNorm(H, eps=1e-12))
    std = 0.02

    def init(m):
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.data = nn.init.trunc_normal_(m.weight.data.to(torch.float32), mean=0.0, std=std)
            if m.bias is not None:
                m.bias.data.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.bias.data.zero_()
            m.weight.data.fill_(1.0)
        elif isinstance(m, Embeddings):
            m.position_embeddings.data = nn.init.trunc_normal_(m.position_embeddings.data.to(torch.float32),
                                                               mean=0.0, std=std)
            m.cls_token.data = nn.init.trunc_normal_(m.cls_token.data.to(torch.float32), mean=0.0, std=std)

    with torch.no_grad():
        return hf_initialise(model, init)


def write_vit(ckpt: pathlib.Path, seed: int, weights: bool):
    """JAX's tiny ViT checkpoint (HF ViTModel at torch.manual_seed(seed))
    with transformers; without, its config.json and the same weights
    (`hf_vit_state_dict`) as pytorch_model.bin."""
    ckpt.mkdir()
    if weights:
        import torch
        from safetensors.torch import save_file
        from transformers import ViTConfig, ViTModel

        torch.manual_seed(seed)
        cfg = ViTConfig(**VIT)
        cfg.save_pretrained(str(ckpt))
        save_file({k: v.contiguous() for k, v in ViTModel(cfg, add_pooling_layer=False).state_dict().items()},
                  str(ckpt / "model.safetensors"))
        return
    import torch

    cfg = dict(model_type="vit", architectures=["ViTModel"], hidden_act="gelu", layer_norm_eps=1e-12,
               num_channels=3, qkv_bias=True, **VIT)
    (ckpt / "config.json").write_text(json.dumps(cfg, indent=2))
    torch.save(hf_vit_state_dict(seed), ckpt / "pytorch_model.bin")


def write_shards(shard_dir: pathlib.Path, imgs, caps) -> str:
    """JAX's four PNG tar shards of the renders and captions (Pillow)."""
    from PIL import Image

    shard_dir.mkdir()
    per_shard = len(imgs) // 4
    for s in range(4):
        with tarfile.open(shard_dir / f"shard-{s:04d}.tar", "w") as tf:
            for idx in range(s * per_shard, (s + 1) * per_shard):
                buf = io.BytesIO()
                Image.fromarray(imgs[idx], "RGB").save(buf, format="PNG")  # lossless: crisp colours
                for name, data in ((f"{idx:07d}.png", buf.getvalue()), (f"{idx:07d}.txt", caps[idx].encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(shard_dir / "shard-{0000..0003}.tar")


def pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def build_world(tmp: pathlib.Path, n_train: int, seed: int = 0, weights=None, world=None):
    """JAX's files: (text checkpoint dir, vision checkpoint dir, shard
    pattern or None without Pillow, held-out renders, labels). weights:
    write JAX's HF checkpoint files with transformers (default: where
    transformers and safetensors import), else the same weights without
    it; world: `sample_world`'s output, if drawn already."""
    imgs, caps, ev_imgs, ev_labels = world if world is not None else sample_world(n_train, seed)
    weights = hf_available() if weights is None else weights
    text_ckpt, vis_ckpt = tmp / "tiny-text", tmp / "tiny-vit"
    write_bert(text_ckpt, text_vocab(), 0, TEXT_BERT, weights)
    write_vit(vis_ckpt, 1, weights)
    pattern = write_shards(tmp / "shards", imgs, caps) if pil_available() else None
    return str(text_ckpt), str(vis_ckpt), pattern, ev_imgs, ev_labels


def run_config(text_ckpt, vis_ckpt, pattern, out_dir, steps: int, lr: float):
    """JAX's run config (the LiT recipe's shape)."""
    from contrastors_tpu_torch.config import Config

    return Config.from_dict(dict(
        train_args=dict(num_train_steps=steps, learning_rate=lr, weight_decay=0.01,
                        warmup_steps=max(steps // 10, 1), schedule_type="cosine", max_grad_norm=1.0,
                        adam_beta1=0.9, adam_beta2=0.95, log_lr_every=20, log_grads_every=10000, wandb=False,
                        output_dir=out_dir, grad_cache=True, chunk_size=16),
        data_args=dict(image_text_shards=pattern or "in-memory", batch_size=BATCH, eval_batch_size=64, seed=0,
                       workers=0, shuffle=True, train_num_samples=steps * BATCH),
        model_args=dict(model_type="locked_text"),
        text_model_args=dict(model_type="locked_text", model_name=text_ckpt, pooling="mean", freeze=True,
                             pretrained=True, seq_len=SEQ_LEN, attn_impl="sdpa"),
        vision_model_args=dict(model_type="locked_text", model_name=vis_ckpt, pooling="mean",
                               pretrained=True, logit_scale=None, trainable_logit_scale=True,
                               attn_impl="sdpa"),
        transforms=dict(image_size=IMG),
    ))


MEMORY_SHARDS = "memory-{0000..0003}"


def rendered_shards(imgs, caps, tokenizer, cfg, seed: int = 0):
    """The trainer's `ImageTextDataset` over the world's four shards held in
    memory (shard s: samples [s * n / 4, (s + 1) * n / 4), as `write_shards`
    writes them)."""
    from contrastors_tpu_torch.data.image_text import ImageTextDataset
    from contrastors_tpu_torch.data.transforms import ArrayImage

    per_shard = len(imgs) // 4

    class RenderedShards(ImageTextDataset):
        def shard_samples(self, url):
            s = int(url.rsplit("-", 1)[1])
            for i in range(s * per_shard, (s + 1) * per_shard):
                yield {"image": ArrayImage(imgs[i]), "text": caps[i]}

    dargs = cfg.data_args
    return RenderedShards(MEMORY_SHARDS, global_batch_size=dargs.batch_size, tokenizer=tokenizer, image_size=IMG,
                          seq_len=SEQ_LEN, seed=dargs.seed, train_num_samples=dargs.train_num_samples,
                          ship_uint8=True)


def zero_shot(trainer, ev_imgs, ev_labels):
    """The trainer's zero-shot machinery on the attribute classes: the
    prompt-ensemble weights from the frozen text tower, top-1 / top-5 over
    the held-out renders (uint8, normalised on the device as the host's
    pipeline would: at IMG the eval transform's resize and crop are the
    identity)."""
    from contrastors_tpu_torch.eval.zero_shot import evaluate_imagenet, zeroshot_classifier_weights

    weights = zeroshot_classifier_weights(trainer.encode_texts, classnames())
    px = np.ascontiguousarray(ev_imgs.transpose(0, 3, 1, 2))

    def eval_batches():
        for lo in range(0, len(px), 64):
            yield {"pixel_values": px[lo:lo + 64], "labels": ev_labels[lo:lo + 64]}

    return evaluate_imagenet(trainer.encode_images, weights, eval_batches())


def run(steps: int = 400, lr: float = 2e-3, tmp=None, device="cuda", dtype: str = "fp32", weights=None,
        log=print):
    """Build the world in tmp (a new temporary directory by default, removed
    after), eval, train `steps` steps, eval again: the result dict."""
    from contrastors_tpu_torch.eval.stub_tokenizer import VocabTokenizer
    from contrastors_tpu_torch.trainers import ImageTextTrainer

    own = tmp is None
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="vision_train_to_signal_") if own else tmp)
    try:
        world = sample_world(steps * BATCH)
        text_ckpt, vis_ckpt, pattern, ev_imgs, ev_labels = build_world(tmp, steps * BATCH, weights=weights,
                                                                      world=world)
        tok = VocabTokenizer(text_vocab())
        cfg = run_config(text_ckpt, vis_ckpt, pattern, str(tmp / "run"), steps, lr)

        class SignalTrainer(ImageTextTrainer):
            def get_tokenizer(self):
                return tok

            def get_dataloaders(self):
                ds = rendered_shards(world[0], world[1], tok, self.config)
                return ds, ds.num_batches

        random.seed(0)  # the train crop draws from Python's random
        trainer = SignalTrainer(cfg, dtype, device)
        before = zero_shot(trainer, ev_imgs, ev_labels)
        log("init:", {k: round(float(v), 4) for k, v in before.items()})
        steps_run = trainer.train()
        after = zero_shot(trainer, ev_imgs, ev_labels)
        log("after:", {k: round(float(v), 4) for k, v in after.items()})
        with open(os.path.join(str(tmp / "run"), "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    names = classnames()
    return {
        "steps": steps_run,
        "batch": BATCH,
        "num_classes": len(names),
        "chance_top1": round(1.0 / len(names), 4),
        "zeroshot_top1_init": float(before["imagenet_zeroshot_top1"]),
        "zeroshot_top1_after": float(after["imagenet_zeroshot_top1"]),
        "zeroshot_top5_init": float(before["imagenet_zeroshot_top5"]),
        "zeroshot_top5_after": float(after["imagenet_zeroshot_top5"]),
        "loss_curve": [(m["step"], m["loss"]) for m in metrics if "loss" in m and "step" in m],
        "device": str(trainer.device),
    }


def check(result) -> None:
    """JAX's bars: zero-shot top-1 above its value at init, and >= 0.5."""
    b, a = result["zeroshot_top1_init"], result["zeroshot_top1_after"]
    if not a > b:
        raise AssertionError(f"zero-shot top-1 did not improve: {b} -> {a}")
    if not a >= 0.5:
        raise AssertionError(f"trained zero-shot top-1 {a} below the learnable-corpus bar 0.5 "
                             f"(chance {result['chance_top1']})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the result JSON here too")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--tmp", default=None, help="the world's directory (default: a temporary one, removed)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    args = ap.parse_args(argv)
    tmp = None
    if args.tmp:
        tmp = pathlib.Path(args.tmp)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    result = run(args.steps, args.lr, tmp, args.device, args.dtype)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    check(result)
    print("VISION TRAIN-TO-SIGNAL OK")
    return result


if __name__ == "__main__":
    main()
