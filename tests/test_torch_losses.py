"""The port's contrastive losses against `contrastors_tpu/losses.py`.

The same fp32 embeddings (numpy, from a seed) and the same logit scale go
to both sides; loss and accuracy agree within 1e-5 (fp32 logsumexp over at
most 24 columns, in another order), and so do the gradients of the loss
wrt both embedding matrices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu import losses as jl
from contrastors_tpu_torch import losses as tl

ATOL = 1e-5
SCALE = 20.0


def _embs(n_q, n_d, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_q, dim)).astype(np.float32)
    d = rng.normal(size=(n_d, dim)).astype(np.float32)
    d[: n_q * (n_d // n_q) : n_d // n_q] += 0.3 * q  # positives score higher, not always highest
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return q, d


def _both(j_fn, t_fn, q, d):
    (j_loss, j_acc), j_grads = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(q), jnp.asarray(d)
    )
    tq, td = (torch.from_numpy(x).requires_grad_() for x in (q, d))
    t_loss, t_acc = t_fn(tq, td)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), atol=ATOL, rtol=0)
    assert t_acc.item() == pytest.approx(float(j_acc), abs=1e-7)
    for t, j in zip((tq.grad, td.grad), j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    return t_loss.item(), t_acc.item()


@pytest.mark.parametrize("kind", ["square", "hard_negatives", "bidirectional"])
def test_clip_loss_matches_jax(kind):
    n_d = 24 if kind == "hard_negatives" else 12
    q, d = _embs(12, n_d)
    bidir = kind == "bidirectional"
    _, acc = _both(
        lambda a, b: jl.clip_loss(a, b, lambda x: x * SCALE, bidirectional=bidir),
        lambda a, b: tl.clip_loss(a, b, lambda x: x * SCALE, bidirectional=bidir),
        q, d,
    )
    assert 0.0 < acc < 1.0  # the accuracy check sees hits and misses


def test_clip_loss_bidirectional_needs_square_similarity():
    q, d = (torch.from_numpy(x) for x in _embs(4, 8))
    with pytest.raises(ValueError, match="square"):
        tl.clip_loss(q, d, lambda x: x, bidirectional=True)


@pytest.mark.parametrize("weights", [None, [1.0, 0.5, 0.25]])
def test_matryoshka_clip_loss_matches_jax(weights):
    q, d = _embs(12, 12, dim=64, seed=1)
    dims = [16, 32, 64]
    _both(
        lambda a, b: jl.matryoshka_clip_loss(a, b, lambda x: x * SCALE, dims=dims, weights=weights),
        lambda a, b: tl.matryoshka_clip_loss(a, b, lambda x: x * SCALE, dims=dims, weights=weights),
        q, d,
    )
