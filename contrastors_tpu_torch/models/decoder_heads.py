"""Decoder task heads over the causal trunk, counterpart of
`contrastors_tpu/models/decoder_heads.py`.

Each is an nn.Module with the trunk under `model` (`models/decoder.py:
DecoderModel`) and the head under JAX's name, so `convert.flax_to_torch`
carries a JAX head's parameters across as they are:
  * `DecoderForCausalLM`: logits over the vocab by `lm_head` (untied, e.g.
    GPT-NeoX's embed_out) or by the word table (tied, cast to the compute
    dtype); with labels, next-token CE: labels shifted left, the last
    position ignored (-100), a mean over the rest in fp32
    (`lm_cross_entropy`, which keeps no fp32 copy of the logits);
  * `DecoderForSequenceClassification`: `score` (no bias) on the last
    non-pad token's hidden state (HF GPT-NeoX's convention);
  * `DecoderForTokenClassification`: classifier dropout
    (`classifier_dropout`, else `resid_pdrop`) then `classifier` at every
    position, -100 labels ignored. In training mode the dropout draws from
    a generator derived from the forward's `generator` (`ops/dropout.py`),
    as the trunk's do;
  * `DecoderForQuestionAnswering`: `qa_outputs` -> start / end logits, the
    CE of each against its span position clamped to the sequence.
Every head runs on `device` (default "cuda"; "cpu" runs the plain path).
"""

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.models.decoder import DecoderModel
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.nomic_bert import masked_cross_entropy
from contrastors_tpu_torch.ops.dropout import active, dropout, noise_seed, site_generator

# the token head's dropout site under a forward's seed (the trunk's are 1-3)
SITE_HEAD = 4
# rows of the vocab projection taken at once by lm_cross_entropy
CE_CHUNK_ROWS = 4096


class _LMCrossEntropy(torch.autograd.Function):
    """Mean CE over rows with label >= 0, in fp32, a chunk of rows at a
    time: the forward keeps only the row log-normalisers, the backward
    recomputes each chunk's softmax and writes the gradient in the logits'
    dtype. So no fp32 copy of the whole [N, V] logits is ever held."""

    @staticmethod
    def forward(ctx, logits, labels, chunk_rows):
        valid = labels >= 0
        safe = torch.where(valid, labels, 0).to(torch.int64)
        lse = torch.empty(logits.shape[0], dtype=torch.float32, device=logits.device)
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for s in range(0, logits.shape[0], chunk_rows):
            lg = logits[s:s + chunk_rows].float()
            lse[s:s + chunk_rows] = torch.logsumexp(lg, dim=-1)
            gold = lg.gather(-1, safe[s:s + chunk_rows, None])[:, 0]
            total = total + ((lse[s:s + chunk_rows] - gold) * valid[s:s + chunk_rows].float()).sum()
        count = valid.float().sum().clamp_min(1.0)
        ctx.save_for_backward(logits, safe, valid, lse, count)
        ctx.chunk_rows = chunk_rows
        return total / count

    @staticmethod
    def backward(ctx, grad):
        logits, safe, valid, lse, count = ctx.saved_tensors
        out = torch.empty_like(logits)
        scale = grad / count
        for s in range(0, logits.shape[0], ctx.chunk_rows):
            p = torch.exp(logits[s:s + ctx.chunk_rows].float() - lse[s:s + ctx.chunk_rows, None])
            p.scatter_add_(-1, safe[s:s + ctx.chunk_rows, None], -torch.ones_like(p[:, :1]))
            p.mul_((valid[s:s + ctx.chunk_rows].float() * scale)[:, None])
            out[s:s + ctx.chunk_rows] = p.to(logits.dtype)
        return out, None, None


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, chunk_rows: int = CE_CHUNK_ROWS) -> torch.Tensor:
    """`masked_cross_entropy` of [..., V] logits and [...] labels, with no
    fp32 copy of the whole logits kept for the backward."""
    return _LMCrossEntropy.apply(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1).to(logits.device), chunk_rows)


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Next-token targets: labels shifted left, the last position -100."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)], dim=1)


def _span_ce(logits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    pos = pos.reshape(-1).to(logits.device).clamp(0, logits.shape[1] - 1)  # HF clamps to the sequence
    return F.cross_entropy(logits.float(), pos.long())


class DecoderForCausalLM(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.model = DecoderModel(config, dtype=dtype, device=device, remat=remat)
        self.lm_head = None if config.tie_word_embeddings else Dense(
            config.n_embd, config.vocab_size, bias=False, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        hidden = self.model(input_ids, attention_mask=attention_mask, generator=generator)["last_hidden_state"]
        if self.lm_head is None:
            emb = self.model.embed_tokens
            table = (emb if emb is not None else self.model.embeddings.word_embeddings).weight
            logits = hidden @ table.to(self.dtype).t()
        else:
            logits = self.lm_head(hidden)
        out: Dict[str, Any] = {"logits": logits}
        if labels is not None:
            out["loss"] = lm_cross_entropy(logits, shift_labels(labels.to(logits.device)))
        return out


class DecoderForSequenceClassification(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.model = DecoderModel(config, dtype=dtype, device=device)
        self.score = Dense(config.n_embd, config.num_labels, bias=False, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        hidden = self.model(input_ids, attention_mask=attention_mask, generator=generator)["last_hidden_state"]
        B, S = hidden.shape[:2]
        if attention_mask is not None:
            last = attention_mask.sum(dim=-1).long() - 1
        else:
            last = torch.full((B,), S - 1, dtype=torch.int64, device=hidden.device)
        pooled = hidden[torch.arange(B, device=hidden.device), last.to(hidden.device)]
        logits = self.score(pooled)
        out: Dict[str, Any] = {"logits": logits}
        if labels is not None:
            out["loss"] = F.cross_entropy(logits.float(), labels.to(logits.device).long())
        return out


class DecoderForTokenClassification(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.model = DecoderModel(config, dtype=dtype, device=device)
        self.classifier = Dense(config.n_embd, config.num_labels, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.config
        hidden = self.model(input_ids, attention_mask=attention_mask, generator=generator)["last_hidden_state"]
        p_drop = cfg.classifier_dropout if cfg.classifier_dropout is not None else cfg.resid_pdrop
        if active(p_drop, self.training):
            hidden = dropout(hidden, p_drop, site_generator(noise_seed(generator), SITE_HEAD, device=hidden.device))
        logits = self.classifier(hidden)
        out: Dict[str, Any] = {"logits": logits}
        if labels is not None:
            out["loss"] = masked_cross_entropy(logits, labels)
        return out


class DecoderForQuestionAnswering(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.model = DecoderModel(config, dtype=dtype, device=device)
        self.qa_outputs = Dense(config.n_embd, 2, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                start_positions: Optional[torch.Tensor] = None, end_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        hidden = self.model(input_ids, attention_mask=attention_mask, generator=generator)["last_hidden_state"]
        logits = self.qa_outputs(hidden)
        out: Dict[str, Any] = {"start_logits": logits[..., 0], "end_logits": logits[..., 1]}
        if start_positions is not None and end_positions is not None:
            out["loss"] = 0.5 * (_span_ce(out["start_logits"], start_positions)
                                 + _span_ce(out["end_logits"], end_positions))
        return out
