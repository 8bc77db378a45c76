"""Contrastive losses: InfoNCE/CLIP and Matryoshka, and the router aux.

Counterpart of `contrastors_tpu/losses.py` (`_ce`, `clip_loss`,
`clip_loss_symmetric`, `matryoshka_clip_loss`, `router_aux_loss`). With
`group=None` the inputs are the whole batch and labels are plain row
indices. With a process group (`Mesh.group`, JAX's `axis_name`) the inputs
are this rank's rows: the other side is all-gathered differentiably
(`parallel/collectives.py:all_gather_rows`), the labels are offset by the
rank as JAX offsets them by `axis_index`, and the loss and accuracy are
means over the local rows. Their mean over the ranks is the global batch's
loss; the data-parallel steps (`make_standard_train_step`,
`grad_cache_loss_and_grads`) backpropagate loss / world and sum the
parameter gradients over the ranks.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from contrastors_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_sum, group_rank, group_size


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
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE over q @ D.T in fp32 with hard-negative support: the document
    rows may be a multiple `mult` of the query rows, and query i's positive
    is document i * mult. Returns (loss, accuracy); accuracy is the share of
    queries whose highest-scoring document is their positive (first index
    on ties, as jnp.argmax). With a group, the documents (and for
    bidirectional the queries) of every rank are gathered and query i of
    rank r has the global label (i + r * n_local) * mult."""
    query, document = query.float(), document.float()
    n = query.shape[0]
    world = group_size(group)
    offset = group_rank(group) * n
    document_g = all_gather_rows(document, group)
    # stretch labels when documents carry hard negatives
    mult = document_g.shape[0] // (n * world)
    labels = (torch.arange(n, device=query.device) + offset) * mult
    sim_qd = logit_scale(query @ document_g.T)
    loss = _ce(sim_qd, labels)
    accuracy = (sim_qd.argmax(dim=-1) == labels).float().mean()
    if bidirectional:
        # document -> query direction; square similarity only, as in JAX
        if mult != 1:
            raise ValueError("bidirectional clip_loss requires square similarity")
        query_g = all_gather_rows(query, group)
        d_labels = torch.arange(document.shape[0], device=query.device) + offset
        loss = loss + _ce(logit_scale(document @ query_g.T), d_labels)
    return loss, accuracy


def clip_loss_symmetric(
    image_emb: torch.Tensor,
    text_emb: torch.Tensor,
    logit_scale: Callable[[torch.Tensor], torch.Tensor],
    group=None,
) -> torch.Tensor:
    """The symmetric CLIP loss in fp32: the mean of the image -> text and
    text -> image cross-entropies, row i of each the other's positive. With
    a group both towers are gathered and the local rows score against the
    global ones (reference modeling_dual_encoder.py:36-68)."""
    image_emb, text_emb = image_emb.float(), text_emb.float()
    n = image_emb.shape[0]
    image_g, text_g = all_gather_rows(image_emb, group), all_gather_rows(text_emb, group)
    labels = torch.arange(n, device=image_emb.device) + group_rank(group) * n
    loss_i = _ce(logit_scale(image_emb @ text_g.T), labels)
    loss_t = _ce(logit_scale(text_emb @ image_g.T), labels)
    return (loss_i + loss_t) / 2.0


def matryoshka_clip_loss(
    query: torch.Tensor,
    document: torch.Tensor,
    logit_scale: Callable[[torch.Tensor], torch.Tensor],
    dims: Sequence[int],
    weights: Optional[Sequence[float]] = None,
    bidirectional: bool = False,
    group=None,
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
                              bidirectional=bidirectional, group=group)
        total = total + w * loss
        if dim == max_dim:
            full_acc = acc
    return total / sum(weights), full_acc


def router_aux_loss(
    router_logits: List[torch.Tensor],
    num_experts: int,
    top_k: int,
    attention_mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Switch-style load-balance loss over the MoE layers' concatenated
    [L*N, E] router logits, with the attention-mask correction, times
    num_experts: 2.0 for top-2 routing that is exactly balanced.

    With a group the statistics are those of the global tokens, as JAX's
    loss on a global batch: the expert counts and the token count are
    summed over the ranks (they carry no gradient), and this rank's value
    is the global fractions times its own probability sums over its share
    of the tokens (the global count over the world size). Its mean over the
    ranks is the global loss, and so is its gradients' mean, as for every
    loss under a group."""
    logits = torch.cat([r.float() for r in router_logits], dim=0)
    weights = torch.softmax(logits, dim=-1)
    _, selected = torch.topk(weights, top_k, dim=-1)  # [L*N, k]
    # one-hot [L*N, k, E] by scatter: no host sync on the card
    expert_mask = logits.new_zeros((*selected.shape, num_experts)).scatter_(2, selected[..., None], 1.0)
    m = (attention_mask.reshape(-1).float().repeat(logits.shape[0] // attention_mask.numel())
         if attention_mask is not None else logits.new_ones(logits.shape[0]))  # [L*N]
    counts = all_reduce_sum(torch.cat([torch.einsum("nke,n->ke", expert_mask, m).reshape(-1), m.sum()[None]]),
                            group)
    denom = counts[-1].clamp_min(1.0)
    tokens_per_expert = counts[:-1].view(top_k, num_experts) / denom
    router_prob_per_expert = torch.einsum("ne,n->e", weights, m) / (denom / group_size(group))
    return (tokens_per_expert * router_prob_per_expert[None, :]).sum() * num_experts
