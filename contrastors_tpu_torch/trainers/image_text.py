"""The CLIP / LiT image-text trainer (model_type clip | locked_text), in
PyTorch.

Counterpart of `contrastors_tpu/trainers/image_text.py`: a
`DualEncoder` whose text tower is frozen under `locked_text` (its trunk
runs without gradients; its parameters get requires_grad=False and stay out
of the optimizer, where JAX's `frozen_mask` zeroes their updates) and a
trainable ViT, the tar-shard image-text data, the symmetric CLIP loss, the
ImageNet zero-shot and Flickr retrieval evals, and the vision tower's
export.

The step:
  - standard: one forward and backward of the dual encoder
    (`make_standard_train_step`);
  - grad_cache: `grad_cache_loss_and_grads` with the image tower as the
    query side and the text tower as the document side; a frozen or
    precomputed text tower is not replayed (d_trainable=False) and its
    direct chunks are forced to 0; the logit scale is the loss stage's
    `extra_params`, whose gradient lands in its .grad beside the towers'.
Both log the loss, the pre-clip global gradient norm (the frozen text
tower has no gradient, as its JAX gradient is 0, so the two norms are
equal) and exp(logit scale) after the update.

Pixels may arrive as uint8 CHW (the loader ships them so under grad_cache):
they are normalised on the device in fp32 and cast to the compute dtype
after, bit-identical to the host's fp32 pipeline. JAX normalises uint8 only
in its grad-cache step, whose loader alone ships them; the port does it in
both steps.

With a process group (the data axis, JAX's `:148-250`) each rank reads
its rows of every global batch (the loader's rank window), both steps'
symmetric loss gathers both towers over the ranks, the step divides it by
the world size, and the gradients are summed over the ranks (grad cache per
rank, chunk_size per rank, as JAX's `shard_map` body).
`grad_cache_embed_parallel` = m embeds m chunks of each tower per pass-1
forward (`grad_cache.py`), the knob JAX made for the vision step's many
small launches.
"""

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from contrastors_tpu_torch.config import OPENAI_IMAGE_MEAN, OPENAI_IMAGE_STD
from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss_symmetric
from contrastors_tpu_torch.models.dual_encoder import DualEncoder
from contrastors_tpu_torch.ops.dropout import noise_seed, step_generator
from contrastors_tpu_torch.parallel.mesh import divisor_chunk
from contrastors_tpu_torch.parallel.sharding import gather_state_dict
from contrastors_tpu_torch.utils import dist as dist_utils
from contrastors_tpu_torch.trainers.base import BaseTrainer, make_standard_train_step

Batch = Dict[str, torch.Tensor]


class ImageTextTrainer(BaseTrainer):
    def _uses_grad_accumulation(self) -> bool:
        return False  # the custom step updates every loop step

    def get_tokenizer(self):
        margs = self.config.text_model_args
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(margs.tokenizer_name or margs.model_name)

    def get_model(self) -> DualEncoder:
        from contrastors_tpu_torch.models.auto import load_biencoder

        text_args, vision_args = self.config.text_model_args, self.config.vision_model_args
        text, text_cfg = load_biencoder(text_args, dtype=self.dtype, device=self.device, seed=self.seed)
        vision, self.trunk_config = load_biencoder(vision_args, dtype=self.dtype, device=self.device,
                                                   seed=self.seed + 1)
        self.dual = DualEncoder(
            text_cfg,
            self.trunk_config,
            text_pooling=text_args.pooling or "mean",
            vision_pooling=vision_args.pooling or "map",
            freeze_text=text_args.freeze,
            text_hamming=text_args.hamming,
            logit_scale_init=vision_args.logit_scale,
            trainable_logit_scale=vision_args.trainable_logit_scale,
            dtype=self.dtype,
            device=self.device,
            remat=vision_args.gradient_checkpointing,
        )
        # strict: a tower tensor with no home, of another shape, or a tower
        # parameter left without a value raises (JAX's `_overlay_tower`)
        self.dual.text.load_state_dict(text.state_dict())
        self.dual.vision.load_state_dict(vision.state_dict())
        return self.dual

    def frozen_mask(self) -> Dict[str, bool]:
        freeze = self.config.text_model_args.freeze
        return {name: not (freeze and name.startswith("text.")) for name, _ in self.model.named_parameters()}

    def get_dataloaders(self):
        from contrastors_tpu_torch.data.image_text import ImageTextDataset, SharedEpoch

        dargs, text_args, t = self.config.data_args, self.config.text_model_args, self.config.transforms
        self.shared_epoch = SharedEpoch(0)
        ds = ImageTextDataset(
            dargs.image_text_shards,
            global_batch_size=dargs.batch_size,
            tokenizer=self.tokenizer,
            image_size=t.image_size if t else 224,
            seq_len=text_args.seq_len or 77,
            seed=dargs.seed,
            resampled=dargs.dataset_resampled,
            train_num_samples=dargs.train_num_samples,
            precomputed_text=text_args.precomputed,
            shared_epoch=self.shared_epoch,
            mean=t.mean if t else None,
            std=t.std if t else None,
            mlm_prob=dargs.mlm_prob,
            ship_uint8=bool(self.config.train_args.grad_cache),
            process_index=self.mesh.rank,
            process_count=self.mesh.data,
        )
        return ds, ds.num_batches or (dargs.train_num_samples or 10**9) // dargs.batch_size

    def _pixel_stats(self, device):
        """(mean, std) as fp32 [3, 1, 1] tensors on `device`, copied there
        once (a copy per step would wait on the host)."""
        cache = self.__dict__.setdefault("_stats", {})
        if device not in cache:
            t = self.config.transforms
            mean = torch.tensor(t.mean if t and t.mean else OPENAI_IMAGE_MEAN, dtype=torch.float32)
            std = torch.tensor(t.std if t and t.std else OPENAI_IMAGE_STD, dtype=torch.float32)
            cache[device] = mean.reshape(3, 1, 1).to(device), std.reshape(3, 1, 1).to(device)
        return cache[device]

    def pixels(self, px: torch.Tensor) -> torch.Tensor:
        """uint8 pixels normalised in fp32 on their device, then cast to the
        compute dtype; float pixels as they are."""
        if px.dtype != torch.uint8:
            return px
        mean, std = self._pixel_stats(px.device)
        return ((px.float() / 255.0 - mean) / std).to(self.dtype)

    def _metrics(self, loss, grad_norm) -> Dict[str, torch.Tensor]:
        return {"loss": loss, "grad_norm": grad_norm,
                "logit_scale": self.dual.logit_scale.logit_scale.detach().exp()}

    def make_train_step(self):
        ta = self.config.train_args
        if ta.grad_cache:
            return self._grad_cache_step()

        def loss_fn(batch, generator):
            out = self.dual(input_ids=batch.get("input_ids"), attention_mask=batch.get("attention_mask"),
                            pixel_values=self.pixels(batch["pixel_values"]),
                            text_embeddings=batch.get("text_embeddings"), generator=generator, group=self.group)
            return out["loss"], {}

        step = make_standard_train_step(loss_fn, self.optimizer, self.scheduler, group=self.group)

        def train_step(batch: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
            m = step(batch, generator)
            return self._metrics(m["loss"], m["grad_norm"])

        return train_step

    def _grad_cache_step(self):
        ta, text_args = self.config.train_args, self.config.text_model_args
        chunk = ta.chunk_size or 64
        text_trainable = not (text_args.freeze or text_args.precomputed)
        # a direct text chunk would hold a graph no one reads when the text is frozen
        direct_q = ta.grad_cache_direct_chunks_q
        direct_d = ta.grad_cache_direct_chunks_d if text_trainable else 0

        def encode_image(dual, chunk_batch, generator, chunks=1):
            # the ViT has no MoE layers to route by chunk
            return {"embedding": dual.encode_image(self.pixels(chunk_batch["pixel_values"]), generator=generator)}

        def encode_text(dual, chunk_batch, generator, chunks=1):
            if "text_embeddings" in chunk_batch:
                return {"embedding": chunk_batch["text_embeddings"]}
            return {"embedding": dual.encode_text(chunk_batch["input_ids"], chunk_batch["attention_mask"],
                                                  generator=generator, moe_groups=chunks)}

        def loss_fn(img, txt, scale):
            # a rank's share: the shares add up to the global batch's loss
            return clip_loss_symmetric(img, txt, scale, group=self.group)

        def train_step(batch: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
            img_b = {"pixel_values": batch["pixel_values"]}
            txt_b = ({"text_embeddings": batch["text_embeddings"]} if "text_embeddings" in batch
                     else {"input_ids": batch["input_ids"], "attention_mask": batch["attention_mask"]})
            self.optimizer.zero_grad(set_to_none=True)
            loss = grad_cache_loss_and_grads(
                self.dual, img_b, txt_b, encode_image, encode_text, loss_fn,
                chunk_size=divisor_chunk(chunk, img_b["pixel_values"].shape[0]),
                rng=noise_seed(step_generator(generator)), d_trainable=text_trainable,
                extra_params=self.dual.logit_scale, direct_chunks=direct_q, direct_chunks_d=direct_d,
                embed_parallel=ta.grad_cache_embed_parallel, group=self.group,
            )
            self.optimizer.step()
            self.scheduler.step()
            return self._metrics(loss, self.optimizer.grad_norm)

        return train_step

    # -- eval ------------------------------------------------------------------
    def encode_images(self, pixel_values: np.ndarray) -> np.ndarray:
        """Normalised image embeddings of a host batch, in eval mode."""
        from contrastors_tpu_torch.eval.encoder import eval_mode

        with eval_mode(self.dual), torch.inference_mode():
            px = self.pixels(torch.from_numpy(np.asarray(pixel_values)).to(self.device))
            return self.dual.encode_image(px).float().cpu().numpy()

    def encode_token_ids(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        """Normalised text embeddings of tokenised rows, in eval mode."""
        from contrastors_tpu_torch.eval.encoder import eval_mode

        with eval_mode(self.dual), torch.inference_mode():
            ids = torch.from_numpy(np.asarray(input_ids)).to(self.device)
            mask = torch.from_numpy(np.asarray(attention_mask)).to(self.device)
            return self.dual.encode_text(ids, mask).float().cpu().numpy()

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        enc = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.config.text_model_args.seq_len or 77, return_tensors="np")
        return self.encode_token_ids(enc["input_ids"], enc["attention_mask"])

    def imagenet_batches(self):
        """The zero-shot eval's {pixel_values, labels} batches: the class
        folders of data_args.imagenet_val_path (`get_imagenet`)."""
        from contrastors_tpu_torch.data.image_text import get_imagenet

        dargs = self.config.data_args
        return get_imagenet(dargs.imagenet_val_path, batch_size=dargs.eval_batch_size)

    def eval_loop(self, step: int) -> Dict[str, float]:
        dargs = self.config.data_args
        metrics = {}
        if dargs.eval_flickr and dargs.flickr_shards:
            metrics.update(self._flickr_eval())
        if not dargs.imagenet_val_path:
            return metrics
        from contrastors_tpu_torch.data.constants import IMAGENET_CLASSNAMES
        from contrastors_tpu_torch.eval.zero_shot import evaluate_imagenet, zeroshot_classifier_weights

        weights = zeroshot_classifier_weights(self.encode_texts, IMAGENET_CLASSNAMES)
        metrics.update(evaluate_imagenet(self.encode_images, weights, self.imagenet_batches()))
        return metrics

    def _flickr_eval(self) -> Dict[str, float]:
        """Flickr-style paired retrieval recall on data_args.flickr_shards."""
        from contrastors_tpu_torch.data.image_text import ImageTextDataset
        from contrastors_tpu_torch.eval.image_text_retrieval import evaluate_image_text_retrieval

        dargs, t = self.config.data_args, self.config.transforms
        ds = ImageTextDataset(
            dargs.flickr_shards,
            global_batch_size=dargs.eval_batch_size,
            tokenizer=self.tokenizer,
            image_size=t.image_size if t else 224,
            is_train=False,
            seq_len=self.config.text_model_args.seq_len or 77,
            shuffle_buffer=0,
        )
        res = evaluate_image_text_retrieval(self.encode_images, self.encode_token_ids, iter(ds))
        return {f"flickr/{k}": v for k, v in res.items()}

    def save_vision_tower(self, out_dir: str) -> str:
        """The vision tower alone, for export, in the port's checkpoint
        format: out_dir/vision_tower/state.pt ({"model": the vision
        BiEncoder's state dict, whole tensors under a split mesh: every rank
        calls it, global rank 0 writes}) beside its trunk_config.json.
        Returns the directory."""
        path = os.path.abspath(os.path.join(out_dir, "vision_tower"))
        state = {k: v.to("cpu", copy=True) for k, v in gather_state_dict(self.dual.vision, self.mesh).items()}
        if self.is_main:
            os.makedirs(path, exist_ok=True)
            torch.save({"model": state}, os.path.join(path, "state.pt"))
            with open(os.path.join(path, "trunk_config.json"), "w") as f:
                f.write(self.trunk_config.to_json())
        dist_utils.barrier()
        return path
