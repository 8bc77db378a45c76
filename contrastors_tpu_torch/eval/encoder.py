"""Inference encoder: BiEncoder -> embeddings for MTEB/BEIR-style evals.

Counterpart of `contrastors_tpu/eval/encoder.py:Encoder`. Texts are
tokenised by any tokenizer with the Hugging Face call interface, sorted by
length and batched into power-of-two length buckets (the default), or
padded to `seq_len` (bucketed=False). Prefixes, normalisation,
binarisation and matryoshka slicing are kept. The model runs on the device
its parameters live on.
"""

import contextlib
from typing import List, Optional

import numpy as np
import torch


def corpus_to_texts(corpus) -> List[str]:
    """BEIR/MTEB corpus entries ({title?, text} dicts or raw strings) to
    flat texts."""
    if corpus and isinstance(corpus[0], dict):
        return [(d.get("title", "") + " " + d["text"]).strip() for d in corpus]
    return list(corpus)


@contextlib.contextmanager
def eval_mode(module: torch.nn.Module):
    """Eval mode for one call (JAX passes deterministic=True per call);
    every submodule's training flag is restored after it."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield
    finally:
        for m, training in modes:
            m.training = training


class Encoder:
    def __init__(
        self,
        module: torch.nn.Module,
        tokenizer,
        seq_len: int = 512,
        batch_size: int = 64,
        query_prefix: Optional[str] = "search_query",
        document_prefix: Optional[str] = "search_document",
        normalize: bool = True,
        binarize: bool = False,
        matryoshka_dim: Optional[int] = None,
        bucketed: bool = True,
    ):
        self.module = module
        self.device = next(module.parameters()).device
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.query_prefix = query_prefix
        self.document_prefix = document_prefix
        self.normalize = normalize
        self.binarize = binarize
        self.matryoshka_dim = matryoshka_dim
        # sort by token length and pad each batch to the next power-of-two
        # bucket instead of seq_len; embeddings are identical (pooling and
        # attention mask the pads)
        self.bucketed = bucketed

    def _postprocess(self, emb: np.ndarray) -> np.ndarray:
        emb = emb.astype(np.float32)
        if self.matryoshka_dim:
            emb = emb[:, : self.matryoshka_dim]
        if self.binarize:
            return (emb > 0).astype(np.float32)
        if self.normalize:
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return emb

    def _run_batch(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with eval_mode(self.module), torch.inference_mode():
            out = self.module(
                input_ids=torch.from_numpy(ids).to(self.device),
                attention_mask=torch.from_numpy(mask).to(self.device),
                normalize=False,
            )["embedding"]
            return out.float().cpu().numpy()

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, cap)

    def encode(self, sentences: List[str], prefix: Optional[str] = None) -> np.ndarray:
        bs = self.batch_size
        if prefix:
            sentences = [f"{prefix}: {s}" for s in sentences]

        if not self.bucketed:
            out = []
            for start in range(0, len(sentences), bs):
                chunk = sentences[start : start + bs]
                texts = chunk + [""] * (bs - len(chunk))  # fixed shape
                enc = self.tokenizer(
                    texts, padding="max_length", truncation=True,
                    max_length=self.seq_len, return_tensors="np",
                )
                emb = self._run_batch(
                    enc["input_ids"].astype(np.int64), enc["attention_mask"].astype(np.int64)
                )[: len(chunk)]
                out.append(emb)
            return self._postprocess(np.concatenate(out))

        # bucketed: tokenise once unpadded, sort by length, batch into
        # power-of-two shapes, un-sort at the end
        enc = self.tokenizer(sentences, padding=False, truncation=True, max_length=self.seq_len)
        ids_list = enc["input_ids"]
        lens = np.asarray([len(x) for x in ids_list], dtype=np.int64)
        order = np.argsort(-lens, kind="stable")
        pad_id = self.tokenizer.pad_token_id or 0
        chunks = []  # (positions, embeddings)
        for start in range(0, len(order), bs):
            idx = order[start : start + bs]
            L = self._bucket(int(lens[idx].max(initial=1)), self.seq_len)
            ids = np.full((bs, L), pad_id, dtype=np.int64)
            mask = np.zeros((bs, L), dtype=np.int64)
            for r, i in enumerate(idx):
                n = min(len(ids_list[i]), L)
                ids[r, :n] = ids_list[i][:n]
                mask[r, :n] = 1
            if len(idx) < bs:
                # fill shape-padding rows with the first real row (an all-pad
                # row would attend over a fully masked row)
                ids[len(idx) :] = ids[0]
                mask[len(idx) :] = mask[0]
            chunks.append((idx, self._run_batch(ids, mask)[: len(idx)]))
        dim = chunks[0][1].shape[-1]
        embs = np.empty((len(sentences), dim), dtype=np.float32)
        for idx, emb in chunks:
            embs[idx] = emb
        return self._postprocess(embs)

    # MTEB / BEIR-style interface
    def encode_queries(self, queries: List[str], **kw) -> np.ndarray:
        return self.encode(queries, prefix=self.query_prefix)

    def encode_corpus(self, corpus, **kw) -> np.ndarray:
        return self.encode(corpus_to_texts(corpus), prefix=self.document_prefix)
