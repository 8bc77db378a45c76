"""Image-text retrieval eval (Flickr / COCO-style recall@k), counterpart of
`contrastors_tpu/eval/image_text_retrieval.py`: both towers encode a paired
validation set; image -> text and text -> image recall@{1, 5, 10}."""

from typing import Callable, Dict, Iterator

import numpy as np


def retrieval_recall(image_embs: np.ndarray, text_embs: np.ndarray, ks=(1, 5, 10)) -> Dict[str, float]:
    """Row i of images matches row i of texts."""
    sim = image_embs @ text_embs.T
    order_i2t = np.argsort(-sim, axis=1)
    order_t2i = np.argsort(-sim.T, axis=1)
    gold = np.arange(sim.shape[0])
    out = {}
    for k in ks:
        out[f"image_to_text_R@{k}"] = float((order_i2t[:, :k] == gold[:, None]).any(1).mean())
        out[f"text_to_image_R@{k}"] = float((order_t2i[:, :k] == gold[:, None]).any(1).mean())
    return out


def evaluate_image_text_retrieval(
    encode_image: Callable[[np.ndarray], np.ndarray],
    encode_text: Callable[[np.ndarray, np.ndarray], np.ndarray],
    batches: Iterator[dict],
    max_samples: int = 5000,
) -> Dict[str, float]:
    """batches: {pixel_values, input_ids, attention_mask} (paired rows)."""
    imgs, txts = [], []
    seen = 0
    for b in batches:
        imgs.append(np.asarray(encode_image(b["pixel_values"])))
        txts.append(np.asarray(encode_text(b["input_ids"], b["attention_mask"])))
        seen += b["pixel_values"].shape[0]
        if seen >= max_samples:
            break
    return retrieval_recall(np.concatenate(imgs), np.concatenate(txts))
