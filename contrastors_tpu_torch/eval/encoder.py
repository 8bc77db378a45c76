"""Inference encoders: BiEncoder -> embeddings for MTEB/BEIR-style evals.

Counterpart of `contrastors_tpu/eval/encoder.py` (`Encoder`, and the
baseline adapters `OpenAIEncoder` and `HFEncoder`). `load_encoder_model`
and `auto_tokenizer` are what the port's CLIs load a local checkpoint
directory with. In `Encoder`, texts are
tokenised by any tokenizer with the Hugging Face call interface, sorted by
length and batched into power-of-two length buckets (the default), or
padded to `seq_len` (bucketed=False). Prefixes, normalisation,
binarisation and matryoshka slicing are kept. The model runs on the device
its parameters live on. With a `mesh` of more than one rank (JAX's `mesh`
form, `:41-80`) every rank calls `encode` with the same texts, encodes its
share of each batch's rows (the batch padded to a multiple of the ranks
with copies of its last row) and the rows are gathered, so each rank gets
the one-rank result, row for row, in the original order. Its MoE layers
route over the whole batch, every rank's share together, as JAX's GSPMD
forward does (`layers/moe.py`, the data axis).
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


def load_encoder_model(model_name: str, pooling: str = "mean", dtype: str = "bf16", device="cuda",
                       trunk_overrides: Optional[dict] = None):
    """(BiEncoder in eval mode, TrunkConfig) of a local HF checkpoint
    directory, through `models/auto.py:load_biencoder`; dtype "bf16",
    "fp32" or a torch dtype (the compute dtype; parameters stay fp32)."""
    from contrastors_tpu_torch._device import DTYPES
    from contrastors_tpu_torch.config import ModelArgs
    from contrastors_tpu_torch.models.auto import load_biencoder

    margs = ModelArgs(model_type="encoder", model_name=model_name, pooling=pooling)
    module, cfg = load_biencoder(margs, dtype=DTYPES[dtype] if isinstance(dtype, str) else dtype, device=device,
                                 trunk_overrides=trunk_overrides)
    return module.eval(), cfg


def auto_tokenizer(model_name: str):
    """`transformers.AutoTokenizer` of a local directory, imported here."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_name)


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
        mesh=None,
    ):
        self.module = module
        self.mesh = mesh if mesh is not None and mesh.data > 1 else None
        if self.mesh is not None:
            from contrastors_tpu_torch.layers.moe import route_over_data

            route_over_data(module, self.mesh.data_part)
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
        if self.mesh is None:
            return self._encode_rows(ids, mask)
        from contrastors_tpu_torch.parallel.collectives import all_gather_rows
        from contrastors_tpu_torch.parallel.mesh import local_rows

        n, w = ids.shape[0], self.mesh.data
        pad = -n % w
        if pad:
            ids, mask = (np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in (ids, mask))
        rows = local_rows(n + pad, self.mesh)
        local = torch.from_numpy(self._encode_rows(ids[rows], mask[rows])).to(self.device)
        return all_gather_rows(local, self.mesh.group).cpu().numpy()[:n]

    def _encode_rows(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
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


class OpenAIEncoder:
    """Baseline adapter over the OpenAI embeddings API (JAX
    `eval/encoder.py:OpenAIEncoder`): token-budget truncation with tiktoken,
    chunked requests with one retry, the MTEB / BEIR encode surface. It
    needs the `openai` and `tiktoken` packages and network access; without
    them construction raises, so A/B tables against API models run
    unchanged only where both exist."""

    def __init__(
        self,
        embedding_model: str = "text-embedding-ada-002",
        batch_size: int = 32,
        cutoff: int = 8192,
        retry_seconds: float = 30.0,
    ):
        try:
            import tiktoken
            from openai import OpenAI
        except ImportError as e:
            raise ImportError(
                "OpenAIEncoder needs the `openai` and `tiktoken` packages (and network access), "
                "which this environment lacks"
            ) from e
        self.client = OpenAI()
        self.embedding_model = embedding_model
        self.encoding = tiktoken.get_encoding("cl100k_base")
        self.batch_size = batch_size
        self.cutoff = cutoff
        self.retry_seconds = retry_seconds

    def _truncate(self, text: str) -> str:
        toks = self.encoding.encode(text)
        return self.encoding.decode(toks[: self.cutoff]) if len(toks) > self.cutoff else text

    def encode(self, sentences: List[str], **kw) -> np.ndarray:
        import time

        sentences = [self._truncate(s) for s in sentences]
        out = []
        for start in range(0, len(sentences), self.batch_size):
            chunk = sentences[start : start + self.batch_size]
            try:
                resp = self.client.embeddings.create(input=chunk, model=self.embedding_model)
            except Exception:
                time.sleep(self.retry_seconds)
                resp = self.client.embeddings.create(input=chunk, model=self.embedding_model)
            out.extend(d.embedding for d in resp.data)
        return np.asarray(out, dtype=np.float32)

    def encode_queries(self, queries: List[str], **kw) -> np.ndarray:
        return self.encode(queries)

    def encode_corpus(self, corpus, **kw) -> np.ndarray:
        return self.encode(corpus_to_texts(corpus))


class HFEncoder:
    """Baseline adapter: any local HF checkpoint as an encoder for A/B
    tables (JAX `eval/encoder.py:HFEncoder`): `transformers.AutoModel` with
    mean pooling over the mask, or a CLIP model's `get_text_features`. The
    model runs on `device` (default "cuda"; pass "cpu" to run without a
    card). `transformers` is imported here, when the adapter is built."""

    def __init__(
        self,
        model_name: str,
        seq_len: int = 512,
        batch_size: int = 16,
        normalize: bool = True,
        query_prefix: Optional[str] = None,
        document_prefix: Optional[str] = None,
        device="cuda",
    ):
        from transformers import AutoModel, AutoTokenizer

        from contrastors_tpu_torch._device import resolve_device

        self.device = resolve_device(device)
        self.model = AutoModel.from_pretrained(model_name, trust_remote_code=True).to(self.device).eval()
        self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        self.clip_model = getattr(self.model.config, "model_type", "") == "clip"
        if self.tokenizer.model_max_length > seq_len:
            self.tokenizer.model_max_length = seq_len
        self.batch_size = batch_size
        self.normalize = normalize
        self.query_prefix = query_prefix
        self.document_prefix = document_prefix

    def encode(self, sentences: List[str], prefix: Optional[str] = None) -> np.ndarray:
        if prefix:
            sentences = [f"{prefix}: {s}" for s in sentences]
        out = []
        with torch.inference_mode():
            for start in range(0, len(sentences), self.batch_size):
                enc = self.tokenizer(
                    sentences[start : start + self.batch_size],
                    padding=True, truncation=True, return_tensors="pt",
                ).to(self.device)
                if self.clip_model:
                    pooled = self.model.get_text_features(**enc)
                else:
                    hidden = self.model(**enc)[0]
                    m = enc["attention_mask"].unsqueeze(-1).to(hidden.dtype)
                    pooled = (hidden * m).sum(1) / m.sum(1).clamp(min=1e-9)
                out.append(pooled.float().cpu().numpy())
        emb = np.concatenate(out)
        if self.normalize:
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return emb

    def encode_queries(self, queries: List[str], **kw) -> np.ndarray:
        return self.encode(queries, prefix=self.query_prefix)

    def encode_corpus(self, corpus, **kw) -> np.ndarray:
        return self.encode(corpus_to_texts(corpus), prefix=self.document_prefix)
