"""Zero-shot image classification with prompt-ensembled text classifier
weights, counterpart of `contrastors_tpu/eval/zero_shot.py`.

A class's weight is the mean of the text tower's normalised embeddings over
a prompt ensemble (CLIP's distilled 7-prompt set and the plain photo
prompt), renormalised. Plain numpy around the encoders the caller passes.
"""

from typing import Callable, Iterator, List, Optional

import numpy as np

from contrastors_tpu_torch.eval.metrics import topk_accuracy

PROMPT_TEMPLATES = [
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
    "a photo of a {}.",
]


def zeroshot_classifier_weights(
    encode_text: Callable[[List[str]], np.ndarray],
    classnames: List[str],
    templates: Optional[List[str]] = None,
    batch_size: int = 256,
) -> np.ndarray:
    """encode_text(list of strings) -> [N, D] normalised embeddings.
    Returns [num_classes, D] classifier weights."""
    templates = templates or PROMPT_TEMPLATES
    prompts = [t.format(c) for c in classnames for t in templates]
    embs = [np.asarray(encode_text(prompts[start:start + batch_size]))
            for start in range(0, len(prompts), batch_size)]
    embs = np.concatenate(embs).reshape(len(classnames), len(templates), -1)
    w = embs.mean(axis=1)
    w /= np.linalg.norm(w, axis=-1, keepdims=True) + 1e-12
    return w


def evaluate_imagenet(
    encode_image: Callable[[np.ndarray], np.ndarray],
    classifier_weights: np.ndarray,
    batches: Iterator[dict],
) -> dict:
    """Top-1 / top-5 accuracy over {pixel_values, labels} batches."""
    logits_all, labels_all = [], []
    for batch in batches:
        img = np.asarray(encode_image(batch["pixel_values"]))
        logits_all.append(img @ classifier_weights.T)
        labels_all.append(batch["labels"])
    acc = topk_accuracy(np.concatenate(logits_all), np.concatenate(labels_all), ks=(1, 5))
    return {"imagenet_zeroshot_top1": acc[1], "imagenet_zeroshot_top5": acc[5]}
