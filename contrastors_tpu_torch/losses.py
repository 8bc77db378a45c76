"""Contrastive losses: InfoNCE/CLIP and Matryoshka, on one device.

Counterpart of `contrastors_tpu/losses.py` (`_ce`, `clip_loss`,
`clip_loss_symmetric`, `matryoshka_clip_loss`, `router_aux_loss`), in its
single-device form: there is no `axis_name`, so labels are plain row
indices. The sharded forms (an all-gather over the data-parallel group)
come with the distributed slice (ROADMAP, Queue 1, item 3).
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return (logz - gold).mean()


def clip_loss(
    query: torch.Tensor,
    document: torch.Tensor,
    logit_scale: Callable[[torch.Tensor], torch.Tensor],
    bidirectional: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE over q @ D.T in fp32 with hard-negative support: the document
    rows may be a multiple `mult` of the query rows, and query i's positive
    is document i * mult. Returns (loss, accuracy); accuracy is the share of
    queries whose highest-scoring document is their positive (first index
    on ties, as jnp.argmax)."""
    query, document = query.float(), document.float()
    n = query.shape[0]
    mult = document.shape[0] // n
    labels = torch.arange(n, device=query.device) * mult
    sim_qd = logit_scale(query @ document.T)
    loss = _ce(sim_qd, labels)
    accuracy = (sim_qd.argmax(dim=-1) == labels).float().mean()
    if bidirectional:
        # document -> query direction; square similarity only, as in JAX
        if mult != 1:
            raise ValueError("bidirectional clip_loss requires square similarity")
        d_labels = torch.arange(document.shape[0], device=query.device)
        loss = loss + _ce(logit_scale(document @ query.T), d_labels)
    return loss, accuracy


def clip_loss_symmetric(
    image_emb: torch.Tensor,
    text_emb: torch.Tensor,
    logit_scale: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The symmetric CLIP loss in fp32: the mean of the image -> text and
    text -> image cross-entropies, row i of each the other's positive."""
    image_emb, text_emb = image_emb.float(), text_emb.float()
    labels = torch.arange(image_emb.shape[0], device=image_emb.device)
    loss_i = _ce(logit_scale(image_emb @ text_emb.T), labels)
    loss_t = _ce(logit_scale(text_emb @ image_emb.T), labels)
    return (loss_i + loss_t) / 2.0


def matryoshka_clip_loss(
    query: torch.Tensor,
    document: torch.Tensor,
    logit_scale: Callable[[torch.Tensor], torch.Tensor],
    dims: Sequence[int],
    weights: Optional[Sequence[float]] = None,
    bidirectional: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean of clip losses on re-normalised prefix slices of the
    embeddings. Returns (loss, accuracy at the largest dim)."""
    if weights is None:
        weights = [1.0] * len(dims)

    def renorm(x, d):
        x = x[..., :d].float()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

    total = 0.0
    full_acc = torch.zeros((), device=query.device)
    max_dim = max(dims)
    for dim, w in zip(dims, weights):
        loss, acc = clip_loss(renorm(query, dim), renorm(document, dim), logit_scale,
                              bidirectional=bidirectional)
        total = total + w * loss
        if dim == max_dim:
            full_acc = acc
    return total / sum(weights), full_acc


def router_aux_loss(
    router_logits: List[torch.Tensor],
    num_experts: int,
    top_k: int,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Switch-style load-balance loss over the MoE layers' concatenated
    [L*N, E] router logits, with the attention-mask correction, times
    num_experts: 2.0 for top-2 routing that is exactly balanced."""
    logits = torch.cat([r.float() for r in router_logits], dim=0)
    weights = torch.softmax(logits, dim=-1)
    _, selected = torch.topk(weights, top_k, dim=-1)  # [L*N, k]
    # one-hot [L*N, k, E] by scatter: no host sync on the card
    expert_mask = logits.new_zeros((*selected.shape, num_experts)).scatter_(2, selected[..., None], 1.0)
    if attention_mask is not None:
        n_layers = logits.shape[0] // attention_mask.numel()
        m = attention_mask.reshape(-1).float().repeat(n_layers)  # [L*N]
        denom = m.sum().clamp_min(1.0)
        tokens_per_expert = torch.einsum("nke,n->ke", expert_mask, m) / denom
        router_prob_per_expert = torch.einsum("ne,n->e", weights, m) / denom
    else:
        tokens_per_expert = expert_mask.mean(dim=0)
        router_prob_per_expert = weights.mean(dim=0)
    return (tokens_per_expert * router_prob_per_expert[None, :]).sum() * num_experts
