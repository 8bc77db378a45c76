"""The multilingual MLM trainer, in PyTorch.

Counterpart of `contrastors_tpu/trainers/mmlm.py`: one directory of
pre-tokenized rows per language under `tokenized_dataset`, each read through
`BaseTrainer.load_dataset`; each step draws its language with
alpha-temperature sampling over the corpus sizes (`MultilingualSampler`,
alpha = 0.3; with `sample_by_reference_lengths`, the published sizes of
`data/constants.py` for the languages present) and takes the next window of
that language's rows from its own cursor, wrapping around at the end. The
batch carries its language, so the loop logs `loss/<lang>`. The model, the
step and the masking are `MLMTrainer`'s, with labels over every position
(no dense_seq_output collation, as in JAX); there is no validation split.
Data-parallel, each rank takes its slice of the language's global window,
and the ranks share the masking generator, as JAX's processes do.
"""

import os
from typing import Dict

import numpy as np

from contrastors_tpu_torch.trainers.mlm import MLMTrainer

SAMPLING_ALPHA = 0.3


class MultilingualSampler:
    """Picks a language with probability proportional to size ** alpha."""

    def __init__(self, sizes: Dict[str, int], alpha: float = SAMPLING_ALPHA, seed: int = 42):
        self.langs = sorted(sizes)
        p = np.asarray([sizes[lang] for lang in self.langs], dtype=np.float64)
        p = (p / p.sum()) ** alpha
        self.probs = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def next_lang(self) -> str:
        return str(self.rng.choice(self.langs, p=self.probs))


class MMLMTrainer(MLMTrainer):
    def get_dataloaders(self):
        dargs = self.config.data_args
        root = dargs.tokenized_dataset
        langs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        datasets = {lang: self.load_dataset(os.path.join(root, lang)) for lang in langs}
        datasets = {lang: (d["train"] if hasattr(d, "keys") and "train" in d else d) for lang, d in datasets.items()}
        sizes = {lang: len(d) for lang, d in datasets.items()}
        sample_sizes = sizes
        if dargs.sample_by_reference_lengths:
            from contrastors_tpu_torch.data.constants import reference_multilingual_lengths

            ref = reference_multilingual_lengths()
            missing = sorted(lang for lang in sizes if lang not in ref)
            if missing:
                print(f"[mmlm] languages {missing} absent from the reference length table; sampling them "
                      "by LOCAL corpus size", flush=True)
            sample_sizes = {lang: ref.get(lang, n) for lang, n in sizes.items()}
        sampler = MultilingualSampler(sample_sizes, seed=dargs.seed)

        self._val = None
        batch = dargs.batch_size
        rank, rank_batch = self.mesh.rank, batch // self.mesh.data
        rng = np.random.default_rng(dargs.seed + 1)
        cursors = {lang: 0 for lang in langs}
        steps = sum(sizes.values()) // batch

        class Loader:
            def __iter__(loader):
                for _ in range(steps):
                    lang = sampler.next_lang()
                    ds = datasets[lang]
                    start = cursors[lang]
                    if start + batch > len(ds):
                        # a corpus smaller than a batch rotates its cursor
                        start = start % len(ds) if batch >= len(ds) else 0
                    cursors[lang] = start + batch
                    # the global window, then this rank's slice of it
                    lo = start + rank * rank_batch
                    ids, mask = self._rows(ds, [i % len(ds) for i in range(lo, lo + rank_batch)])
                    # labels over every position, as JAX's MMLM batches carry them
                    out = self._mask_batch(ids, mask, dargs.mlm_prob, rng, dense=False)
                    yield {"lang": lang, **out}

        return Loader(), steps
