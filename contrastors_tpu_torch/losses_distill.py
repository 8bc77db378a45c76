"""Distillation losses and the student's initialisation from its teacher.

Counterpart of `contrastors_tpu/losses_distill.py`, on one device. The four
loss modes of `distill_loss` (both towers' embeddings normalised in fp32,
the norm floored at 1e-12):

  mse    - the MSE between student and teacher embeddings, per tower;
  kd     - KL(teacher softmax sim || student softmax sim) * 1000 plus the
           student's InfoNCE at temperature 0.02;
  towers - the mean of four InfoNCE terms: s_q -> s_d, s_q -> t_q,
           s_d -> t_d, s_q -> t_d;
  stella - 10 * (1 - cos) per tower, 200 * the MSE of the intra-tower
           similarity matrices, and 20 * a hinge on the signs of pairwise
           score differences (`pairwise_hinge`, in blocks).

`init_student_from_teacher` walks the port's state dict: student layer i
takes teacher layer i * stride, a tensor whose shape differs goes through
`uniform_element_selection`, and a student tensor with no teacher
counterpart keeps its init. Selection per dimension commutes with the
[in, out] -> [out, in] transpose between the two layouts, so the result is
JAX's after `convert.flax_to_torch`.
"""

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from contrastors_tpu_torch.losses import clip_loss


def _norm(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _infonce(q: torch.Tensor, d: torch.Tensor, temperature: float) -> torch.Tensor:
    loss, _ = clip_loss(q, d, lambda x: x / temperature)
    return loss


def _upper_scores(vectors: torch.Tensor) -> torch.Tensor:
    """The upper-triangular pairwise similarity scores, row-major."""
    n = vectors.shape[0]
    iu = torch.triu_indices(n, n, offset=1, device=vectors.device)
    return (vectors @ vectors.T)[iu[0], iu[1]]


def score_diff(vectors: torch.Tensor) -> torch.Tensor:
    """The differences between all upper-triangular pairs of the upper-
    triangular pairwise similarity scores, in JAX's (row-major) order. For
    n vectors that is (n(n-1)/2)^2 / 2 values; `pairwise_hinge` reduces
    over them without building them."""
    s = _upper_scores(vectors)
    m = s.shape[0]
    diff = s[None, :] - s[:, None]
    iu2 = torch.triu_indices(m, m, offset=1, device=vectors.device)
    return diff[iu2[0], iu2[1]]


# fp32 values of the [m, m] score-difference matrix that `pairwise_hinge`
# holds at a time (256 MiB)
HINGE_BLOCK = 1 << 26


def _hinge_block(s: torch.Tensor, t: torch.Tensor, i0: int, i1: int, margin: float) -> torch.Tensor:
    """sum over rows i0 <= i < i1 and j > i of relu((s_j - s_i) * label +
    margin), label 1 where t_j - t_i < 0 and -1 elsewhere."""
    upper = torch.arange(s.shape[0], device=s.device)[None, :] > torch.arange(i0, i1, device=s.device)[:, None]
    label = torch.where(t[None, :] - t[i0:i1, None] < 0, 1.0, -1.0)
    return (torch.relu((s[None, :] - s[i0:i1, None]) * label + margin) * upper).sum()


def pairwise_hinge(student: torch.Tensor, teacher: torch.Tensor, margin: float) -> torch.Tensor:
    """mean(relu(score_diff(student) * label + margin)), label
    where(score_diff(teacher) < 0, 1, -1): stella's triplet term. Reduced in
    blocks of rows of the difference matrix, each recomputed in the backward
    (a checkpoint), so memory is one block and not the (n(n-1)/2)^2 matrix
    and its index tensors."""
    from torch.utils.checkpoint import checkpoint

    s, t = _upper_scores(student), _upper_scores(teacher)
    m = s.shape[0]
    rows = max(1, HINGE_BLOCK // max(m, 1))
    total = sum(checkpoint(_hinge_block, s, t, i0, min(i0 + rows, m), margin,
                           use_reentrant=False, preserve_rng_state=False) for i0 in range(0, m, rows))
    return total / (m * (m - 1) // 2)


def distill_loss(
    loss_fn: str,
    student_q: torch.Tensor,
    student_d: torch.Tensor,
    teacher_q: torch.Tensor,
    teacher_d: torch.Tensor,
    temperature: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """{"loss", and the mode's terms}, fp32 scalars."""
    sq, sd = _norm(student_q), _norm(student_d)
    tq, td = _norm(teacher_q), _norm(teacher_d)

    if loss_fn == "mse":
        q_mse = ((sq - tq) ** 2).mean()
        d_mse = ((sd - td) ** 2).mean()
        return {"loss": q_mse + d_mse, "query_mse": q_mse, "document_mse": d_mse}

    if loss_fn == "kd":
        t_sim = (tq @ td.T) / temperature
        s_sim = (sq @ sd.T) / temperature
        s_logp = torch.log_softmax(s_sim, dim=-1)
        t_p = torch.softmax(t_sim, dim=-1)
        kd = (t_p * (torch.log(t_p.clamp_min(1e-12)) - s_logp)).sum() / s_sim.shape[0]
        infonce = _infonce(sq, sd, 0.02)
        return {"loss": 1000.0 * kd + infonce, "kd_loss": kd, "infonce_loss": infonce}

    if loss_fn == "towers":
        l1 = _infonce(sq, sd, temperature)
        l2 = _infonce(sq, tq, temperature)
        l3 = _infonce(sd, td, temperature)
        l4 = _infonce(sq, td, temperature)
        return {
            "loss": (l1 + l2 + l3 + l4) / 4,
            "loss_infonce_student": l1,
            "loss_teacher_query": l2,
            "loss_teacher_document": l3,
            "loss_infonce_teacher": l4,
        }

    if loss_fn == "stella":
        cos_q = (1 - (sq * tq).sum(dim=1).mean()) * 10
        cos_d = (1 - (sd * td).sum(dim=1).mean()) * 10
        sim_q = ((sq @ sq.T - tq @ tq.T) ** 2).mean() * 200
        sim_d = ((sd @ sd.T - td @ td.T) ** 2).mean() * 200
        trip_q = pairwise_hinge(sq, tq, 0.015) * 20
        trip_d = pairwise_hinge(sd, td, 0.015) * 20
        return {
            "loss": cos_q + cos_d + sim_q + sim_d + trip_q + trip_d,
            "cos_loss_query": cos_q,
            "cos_loss_document": cos_d,
            "sim_loss_query": sim_q,
            "sim_loss_document": sim_d,
            "triplet_loss": trip_q + trip_d,
        }

    raise ValueError(f"unknown distill loss {loss_fn!r}")


def uniform_element_selection(wt: np.ndarray, s_shape: Tuple[int, ...]) -> np.ndarray:
    """Evenly subsample a teacher array along every dimension: every
    (teacher / student)-th index where the student's size divides the
    teacher's, else the rounded linspace over the teacher's range."""
    if wt.ndim != len(s_shape):
        raise ValueError(f"teacher {wt.shape} and student {tuple(s_shape)} differ in rank")
    ws = wt
    for dim in range(wt.ndim):
        if wt.shape[dim] < s_shape[dim]:
            raise ValueError(f"student dim {dim} ({s_shape[dim]}) exceeds the teacher's ({wt.shape[dim]})")
        if wt.shape[dim] % s_shape[dim] == 0:
            idx = np.arange(s_shape[dim]) * (wt.shape[dim] // s_shape[dim])
        else:
            idx = np.round(np.linspace(0, wt.shape[dim] - 1, s_shape[dim])).astype(np.int64)
        ws = np.take(ws, idx, axis=dim)
    return ws


_LAYER = re.compile(r"(^|\.)layers\.(\d+)\.")


def init_student_from_teacher(student: Mapping[str, torch.Tensor], teacher: Mapping[str, torch.Tensor],
                              layer_stride: int = 2) -> Dict[str, torch.Tensor]:
    """A new state dict for the student: each of its tensors taken from the
    teacher's tensor of the same name, with `layers.<i>.` read as the
    teacher's `layers.<i * layer_stride>.`, subsampled by
    `uniform_element_selection` where the shapes differ; a tensor the
    teacher lacks keeps the student's value. Values keep the student's
    dtype and device."""
    out = {}
    for name, s_val in student.items():
        t_name = _LAYER.sub(lambda m: f"{m.group(1)}layers.{int(m.group(2)) * layer_stride}.", name, count=1)
        t_val = teacher.get(t_name)
        if t_val is None:
            out[name] = s_val
            continue
        if tuple(t_val.shape) != tuple(s_val.shape):
            t_val = torch.from_numpy(np.ascontiguousarray(
                uniform_element_selection(t_val.detach().float().cpu().numpy(), tuple(s_val.shape))))
        out[name] = t_val.detach().to(dtype=s_val.dtype, device=s_val.device).clone()
    return out
