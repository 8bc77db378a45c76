"""Image-text tar-shard pipeline (the webdataset format, without webdataset).

Counterpart of `contrastors_tpu/data/image_text.py`: brace-expanded .tar
shards of (image, caption) pairs grouped by basename, a deterministic
epoch-seeded shard shuffle, optional infinite resampling, split by
process, a sample shuffle buffer, PIL decode + transform + tokenize, skipping
a sample that fails, a fixed number of batches per epoch, the
precomputed-text-embedding branch, the caption-MLM branch (the port's
`trainers/mlm.py:mlm_mask`), and the ImageNet-style class-folder loader of
the zero-shot eval. The same code as JAX's: the same shards give the same
batches, pixels and token ids bit for bit. PIL is imported inside the
functions that decode images.
"""

import io
import json
import os
import random
import tarfile
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from contrastors_tpu_torch.data.text import expand_urls
from contrastors_tpu_torch.data.transforms import image_transform

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")
CAPTION_EXTS = (".txt", ".text", ".caption")


def log_and_continue(exn) -> bool:
    """Per-sample fault tolerance: report the sample and go on."""
    print(f"[image_text] skipping sample: {exn!r}")
    return True


def iter_tar_samples(path: str, handler=log_and_continue) -> Iterator[Dict[str, Any]]:
    """Group tar members by basename into {__key__, image: PIL, text: str}."""
    with tarfile.open(path, "r") as tf:
        current_key = None
        sample: Dict[str, Any] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            base, ext = os.path.splitext(name)
            ext = ext.lower()
            if current_key is not None and base != current_key:
                if "image" in sample and ("text" in sample or "text_embedding" in sample):
                    # precomputed-text shards carry .npy embeddings instead
                    # of captions (reference image_text_loader.py:480)
                    yield sample
                sample = {}
            current_key = base
            sample["__key__"] = base
            try:
                data = tf.extractfile(member).read()
                if ext in IMAGE_EXTS:
                    from PIL import Image

                    img = Image.open(io.BytesIO(data))
                    img.load()
                    sample["image"] = img
                elif ext in CAPTION_EXTS:
                    sample["text"] = data.decode("utf-8")
                elif ext == ".json":
                    meta = json.loads(data)
                    if "caption" in meta and "text" not in sample:
                        sample["text"] = meta["caption"]
                    sample["json"] = meta
                elif ext == ".npy":
                    sample["text_embedding"] = np.load(io.BytesIO(data))
            except Exception as e:  # noqa: BLE001
                if not handler(e):
                    raise
        if "image" in sample and ("text" in sample or "text_embedding" in sample):
            yield sample


class SharedEpoch:
    """Epoch counter shared with the trainer so shard shuffles are
    deterministic per epoch."""

    def __init__(self, epoch: int = 0):
        self.epoch = epoch

    def set(self, epoch: int):
        self.epoch = epoch


class ImageTextDataset:
    def __init__(
        self,
        shards: str,
        global_batch_size: int,
        tokenizer,
        image_size: int = 224,
        is_train: bool = True,
        seq_len: int = 77,
        seed: int = 42,
        resampled: bool = False,
        train_num_samples: Optional[int] = None,
        shuffle_buffer: int = 1000,
        process_index: int = 0,
        process_count: int = 1,
        precomputed_text: bool = False,
        shared_epoch: Optional[SharedEpoch] = None,
        mean=None,
        std=None,
        mlm_prob: Optional[float] = None,
        ship_uint8: bool = False,
    ):
        self.urls = expand_urls(shards)
        self.rank = process_index
        self.world = process_count
        self.rank_batch = global_batch_size // process_count
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.seed = seed
        self.resampled = resampled
        self.shuffle_buffer = shuffle_buffer if is_train else 0
        self.is_train = is_train
        self.precomputed_text = precomputed_text
        self.mlm_prob = mlm_prob
        self._mlm_rng = np.random.default_rng(seed + 17)
        self.shared_epoch = shared_epoch or SharedEpoch(0)
        kw = {}
        if mean is not None:
            kw["mean"] = mean
        if std is not None:
            kw["std"] = std
        # ship_uint8: pixels leave the host as raw uint8 CHW (4x smaller
        # copy, no host float pass); the trainer normalises them on the
        # device (trainers/image_text.py)
        self.ship_uint8 = ship_uint8
        self.transform = image_transform(
            image_size, is_train=is_train, ship_uint8=ship_uint8, **kw
        )
        # fixed steps per epoch (webdataset's with_epoch)
        self.num_batches = (
            (train_num_samples // global_batch_size) if train_num_samples else None
        )

    def _shard_order(self) -> List[str]:
        rng = random.Random(self.seed + self.shared_epoch.epoch)
        if self.resampled:
            # infinite resampling (ResampledShards2), the rank folded into
            # the RNG so that every process draws its own shard sequence
            rng = random.Random((self.seed + self.shared_epoch.epoch) * 1_000_003 + self.rank)
            return [rng.choice(self.urls) for _ in range(max(len(self.urls), 1) * 4)]
        urls = list(self.urls)
        if self.is_train:
            rng.shuffle(urls)
        mine = urls[self.rank :: self.world]
        if not mine:
            # fewer shards than processes: duplicating a shard across ranks
            # would put identical samples in the global batch — duplicate
            # positives labeled as negatives in the contrastive loss
            raise ValueError(
                f"{len(urls)} shard(s) for {self.world} processes — rank "
                f"{self.rank} has none; use dataset_resampled=true (rank-"
                f"folded infinite sampling) or provide >= world_size shards"
            )
        return mine

    def shard_samples(self, url: str) -> Iterator[Dict[str, Any]]:
        """A shard's samples ({"image", "text"}) in their order: the tar's
        (a subclass may hold them in memory)."""
        return iter_tar_samples(url)

    def _samples(self) -> Iterator[Dict[str, Any]]:
        buf: List[Dict[str, Any]] = []
        rng = random.Random(self.seed + 1 + self.shared_epoch.epoch)
        for url in self._shard_order():
            try:
                it = self.shard_samples(url)
            except Exception as e:  # noqa: BLE001
                log_and_continue(e)
                continue
            for s in it:
                if self.shuffle_buffer > 1:
                    buf.append(s)
                    if len(buf) >= self.shuffle_buffer:
                        idx = rng.randrange(len(buf))
                        yield buf.pop(idx)
                else:
                    yield s
        rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batch: List[Dict[str, Any]] = []
        produced = 0
        while True:
            for s in self._samples():
                try:
                    s["pixel_values"] = self.transform(s["image"])
                except Exception as e:  # noqa: BLE001
                    log_and_continue(e)
                    continue
                batch.append(s)
                if len(batch) == self.rank_batch:
                    yield self._collate(batch)
                    batch = []
                    produced += 1
                    if self.num_batches and produced >= self.num_batches:
                        return
            if not self.num_batches:
                return
            self.shared_epoch.set(self.shared_epoch.epoch + 1)

    def _collate(self, batch: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        px_dtype = np.uint8 if self.ship_uint8 else np.float32
        out: Dict[str, np.ndarray] = {
            "pixel_values": np.stack([s["pixel_values"] for s in batch]).astype(px_dtype)
        }
        if self.precomputed_text and "text_embedding" in batch[0]:
            out["text_embeddings"] = np.stack([s["text_embedding"] for s in batch]).astype(
                np.float32
            )
        else:
            enc = self.tokenizer(
                [s["text"] for s in batch],
                padding="max_length",
                truncation=True,
                max_length=self.seq_len,
                return_tensors="np",
            )
            out["input_ids"] = enc["input_ids"].astype(np.int32)
            out["attention_mask"] = enc["attention_mask"].astype(np.int32)
            if self.mlm_prob:
                # caption-MLM branch of the multimodal-MLM vision recipe: a
                # masked view of the captions rides along with the CLIP batch
                from contrastors_tpu_torch.trainers.mlm import mlm_mask

                special = set(self.tokenizer.all_special_ids)
                mlm_ids, mlm_labels = mlm_mask(
                    out["input_ids"],
                    self.mlm_prob,
                    self.tokenizer.mask_token_id,
                    len(self.tokenizer),
                    special,
                    self._mlm_rng,
                )
                out["mlm_input_ids"] = mlm_ids.astype(np.int32)
                out["mlm_labels"] = mlm_labels.astype(np.int32)
        return out


def get_imagenet(
    val_path: str, image_size: int = 224, batch_size: int = 256, mean=None, std=None
) -> Iterator[Dict[str, np.ndarray]]:
    """Class-folder loader for zero-shot eval. Yields
    {pixel_values [B,C,H,W], labels [B]} with labels = sorted-folder index."""
    kw = {}
    if mean is not None:
        kw["mean"] = mean
    if std is not None:
        kw["std"] = std
    transform = image_transform(image_size, is_train=False, **kw)
    classes = sorted(d for d in os.listdir(val_path) if os.path.isdir(os.path.join(val_path, d)))
    images, labels = [], []
    for label, cls in enumerate(classes):
        for fname in sorted(os.listdir(os.path.join(val_path, cls))):
            if fname.lower().endswith(IMAGE_EXTS):
                images.append(os.path.join(val_path, cls, fname))
                labels.append(label)
    for start in range(0, len(images), batch_size):
        chunk = images[start : start + batch_size]
        pixels = []
        for path in chunk:
            from PIL import Image

            with Image.open(path) as img:
                pixels.append(transform(img))
        yield {
            "pixel_values": np.stack(pixels).astype(np.float32),
            "labels": np.asarray(labels[start : start + batch_size], dtype=np.int32),
        }
