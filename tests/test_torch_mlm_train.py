"""The port's MLM train step against JAX's standard step.

The JAX side is `BaseTrainer.make_standard_train_step` with the loss of
`MLMTrainer.make_train_step`, built directly: value_and_grad of the MLM
loss per micro-batch, the gradients summed over gradient_accumulation_steps
micro-batches, then AdamW (`utils.optim.make_optimizer` with the MLM
recipe's settings, `configs/train/mlm.yaml`: lr 5e-4, wd 0.01, betas 0.9 /
0.98, eps 1e-6, clip 1.0) on their mean, and `optax.global_norm` of that
mean. The port runs `trainers.mlm.make_mlm_train_step` on the same fp32
parameters (`convert.flax_to_torch`) and batches (numpy, dense_seq_output).
At accumulation 1 and 2: each micro-step's loss within 1e-6 relative,
grad_norm within 1e-5 relative, reported only on the update's micro-step;
the clipped mean gradient the update used within 2e-7 (fp32, a gradient of
norm 1); every parameter after the update within 5e-6, 1% of lr (the first
AdamW update is lr * g / (|g| + eps), so for an element whose gradient is a
near-cancelling sum of order eps, the fp32 summation order shifts the
update by up to lr * |dg| / eps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from contrastors_tpu.utils.optim import make_optimizer as j_make_optimizer
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.trainers.mlm import make_mlm_train_step
from contrastors_tpu_torch.utils.optim import make_optimizer
from test_torch_mlm import jax_model_and_params, mlm_batch, port_model
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LR = 5e-4
OPT = dict(weight_decay=0.01, beta1=0.9, beta2=0.98, eps=1e-6, max_grad_norm=1.0)


@pytest.mark.parametrize("ga", [1, 2])
def test_mlm_step_matches_jax_standard_step(ga):
    jm, params = jax_model_and_params()
    batches = [mlm_batch(10 + i) for i in range(ga)]

    def loss(p, b):
        return jm.apply(p, jnp.asarray(b["input_ids"]), attention_mask=jnp.asarray(b["attention_mask"]),
                        labels=jnp.asarray(b["dense_labels"]),
                        masked_positions=jnp.asarray(b["masked_positions"]))["loss"]

    grad_fn = jax.jit(jax.value_and_grad(loss))
    tx = j_make_optimizer(params, LR, **OPT)
    accum, j_losses = None, []
    for b in batches:
        l, g = grad_fn(params, b)
        j_losses.append(float(l))
        accum = g if accum is None else jax.tree_util.tree_map(jnp.add, accum, g)
    mean = jax.tree_util.tree_map(lambda g: g / ga, accum)
    updates, _ = tx.update(mean, tx.init(params), params)
    j_new = flax_to_torch(optax.apply_updates(params, updates))
    j_norm = float(optax.global_norm(mean))
    j_clipped = flax_to_torch(jax.tree_util.tree_map(lambda g: g / max(j_norm, 1.0), mean))

    tm = port_model(params)
    opt = make_optimizer(tm.named_parameters(), LR, **OPT)
    step = make_mlm_train_step(tm, opt, gradient_accumulation_steps=ga)
    for i, b in enumerate(batches):
        m = step({n: torch.from_numpy(x) for n, x in
                  dict(b, labels=b["dense_labels"]).items() if n != "dense_labels"})
        np.testing.assert_allclose(m["loss"].item(), j_losses[i], rtol=1e-6)
        assert ("grad_norm" in m) == (i == ga - 1)
    np.testing.assert_allclose(m["grad_norm"].item(), j_norm, rtol=1e-5)
    assert j_norm > 1.0  # the clip is exercised
    moved = 0.0
    for n, p in tm.named_parameters():  # .grad holds the clipped mean the update used
        torch.testing.assert_close(p.grad, j_clipped[n], atol=2e-7, rtol=0, msg=n)
        torch.testing.assert_close(p.detach(), j_new[n], atol=5e-6, rtol=0, msg=n)
        moved = max(moved, (j_new[n] - flax_to_torch(params)[n]).abs().max().item())
    assert moved > 0.5 * LR  # the update is not a no-op
