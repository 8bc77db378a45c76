"""Dropout and drop-path in the port against JAX's, by mask replay.

The two sides draw from different generators, so the port's noise cannot
equal JAX's. Instead the JAX side runs once eagerly with its keep masks
recorded: flax's `nn.Dropout`, JAX's `ops/sdpa.py` and `_drop_path` all draw
through `jax.random.bernoulli`, which a test-local patch wraps, so the
record holds every site's mask in call order. The port then runs with
`ops/dropout.py:keep_mask` replaced by a replay of that record, so that its
one dropout function applies JAX's masks, in its own call order (a site out
of order fails on the mask's shape, and every mask must be used). Outputs
agree within 1e-5 absolute + 1e-4 relative in fp32, and each parameter's
gradient (JAX's under `jax.grad` with the same rng, hence the same masks) at
cosine >= 0.9999: `Block` (postnorm, prenorm, drop-path in both, a MoE block
with `moe_resid_pdrop`), `NomicBertModel` (postnorm with embedding dropout,
prenorm with the final dropout), `NomicBertForPreTraining`,
`NomicBertForSequenceClassification` and `sdpa`. At rate 1.0 both sides
return zeros without a draw, site by site. Then the port's own generators:
the same seed draws the same noise, another seed other noise; `remat` on
and off, and grad cache's cached and direct chunks, give bit-identical
gradients with dropout on; training mode with a dropout and no generator
raises; `drop_path_rate` on `NomicBertModel` is ignored, as JAX ignores it.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers.block import Block as JBlock
from contrastors_tpu.models import presets as jpre
from contrastors_tpu.models.nomic_bert import (NomicBertForPreTraining as JMLM, NomicBertForSequenceClassification
                                               as JCls, NomicBertModel as JModel)
from contrastors_tpu.ops.sdpa import sdpa as j_sdpa
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.models import (BiEncoder, NomicBertForPreTraining, NomicBertForSequenceClassification,
                                          NomicBertModel)
from contrastors_tpu_torch.models import presets as tpre
from contrastors_tpu_torch.ops import dropout as tdrop
from contrastors_tpu_torch.ops.sdpa import sdpa
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(n_layer=2, n_embd=64, n_head=2, n_inner=128, vocab_size=256)
DROP = dict(resid_pdrop=0.1, embd_pdrop=0.15, attn_pdrop=0.2)
MOE = dict(num_experts=4, moe_top_k=2, moe_every_n_layers=2)
B, S = 3, 16
KEY = jax.random.PRNGKey(7)


@contextlib.contextmanager
def jax_masks():
    """The keep masks drawn inside, in call order."""
    masks, draw = [], jax.random.bernoulli

    def recording(*args, **kwargs):
        m = draw(*args, **kwargs)
        masks.append(np.asarray(m))
        return m

    jax.random.bernoulli = recording
    try:
        yield masks
    finally:
        jax.random.bernoulli = draw


@contextlib.contextmanager
def replay(masks, monkeypatch):
    """The port's keep_mask hands out `masks` in order."""
    queue = list(masks)

    def keep_mask(shape, keep, generator, device):
        assert queue, "the port draws more masks than JAX"
        m = queue.pop(0)
        assert tuple(m.shape) == tuple(shape), (m.shape, tuple(shape))
        return torch.from_numpy(m).to(device)

    with monkeypatch.context() as m:
        m.setattr(tdrop, "keep_mask", keep_mask)
        yield
    assert not queue, f"{len(queue)} JAX masks left unused"


def no_draws(monkeypatch):
    def keep_mask(*args):
        raise AssertionError("a draw at rate 0 or 1")

    monkeypatch.setattr(tdrop, "keep_mask", keep_mask)


def randomised(variables, seed):
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.02, size=x.shape)).astype(np.float32),
        variables["params"])}


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5, rtol=1e-4)


def grads_agree(module, j_grads):
    want = flax_to_torch(jax.device_get(j_grads))
    got = {n: p.grad for n, p in module.named_parameters() if p.grad is not None}
    assert set(got) == set(want), set(got) ^ set(want)
    for name, g in got.items():
        a, b = g.double().flatten(), want[name].double().flatten()
        if float(b.norm()) == 0.0:
            assert float(a.norm()) <= 1e-7, name
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.9999, (name, cos)


def inputs(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    mask = (np.arange(S)[None] < np.array([S, 11, 6])[:, None]).astype(np.int32)
    ids = rng.integers(5, vocab, size=(B, S)) * mask
    return ids.astype(np.int32), mask, rng


BLOCK_CASES = {
    "postnorm": (dict(), dict()),
    "prenorm": (dict(prenorm=True), dict()),
    "postnorm_drop_path": (dict(), dict(drop_path_rate1=0.25, drop_path_rate2=0.4)),
    "prenorm_drop_path": (dict(prenorm=True), dict(drop_path_rate1=0.25, drop_path_rate2=0.4)),
    "moe_postnorm": (dict(MOE, moe_resid_pdrop=0.3), dict(moe=True)),
    "moe_prenorm": (dict(MOE, moe_resid_pdrop=0.3, prenorm=True), dict(moe=True)),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_replays_jax_masks(case, monkeypatch):
    over, kw = BLOCK_CASES[case]
    cfg = dict(SMALL, **DROP, **over)
    _, mask, rng = inputs(1)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    res = rng.normal(size=(B, S, 64)).astype(np.float32) if cfg.get("prenorm") else None
    w = rng.normal(size=(B, S, 64)).astype(np.float32) * mask[:, :, None]  # valid rows only (MoE)
    jb = JBlock(config=jpre.nomic_bert_2048(attn_impl="sdpa", **cfg), **kw)
    jargs = (jnp.asarray(x), None if res is None else jnp.asarray(res), jnp.asarray(mask))
    params = randomised(jax.jit(jb.init)(jax.random.PRNGKey(0), *jargs), 2)

    def j_loss(p):
        h, r, _ = jb.apply(p, *jargs, None, None, None, False, rngs={"dropout": KEY})
        return (h * w).sum() + (0.0 if r is None else (r * w).sum()), (h, r)

    with jax_masks() as masks:
        _, (jh, jr) = j_loss(params)
    j_grads = jax.grad(lambda p: j_loss(p)[0])(params)["params"]
    n_sites = 5 if "drop_path" in case else 3
    assert len(masks) == n_sites

    tb = Block(tpre.nomic_bert_2048(attn_impl="flash", **cfg), device="cpu", **kw)
    tb.load_state_dict(flax_to_torch(params), strict=True)
    tw = torch.from_numpy(w)
    with replay(masks, monkeypatch):
        h, r, _ = tb(torch.from_numpy(x), None if res is None else torch.from_numpy(res),
                     torch.from_numpy(mask), dropout_seed=0)
        ((h * tw).sum() + (0.0 if r is None else (r * tw).sum())).backward()
    close(h * tw, jh * w)
    if r is not None:
        close(r, jr)
    grads_agree(tb, j_grads)


def _model_case(name):
    """(JAX module, port module class, config kwargs, preset)."""
    return {
        "model_postnorm": (JModel, NomicBertModel, dict(SMALL, **DROP), "nomic_bert_2048"),
        "model_prenorm": (JModel, NomicBertModel, dict(SMALL, **DROP, prenorm=True), "nomic_bert_2048"),
        "pretraining": (JMLM, NomicBertForPreTraining, dict(SMALL, **DROP), "nomic_bert_2048"),
        "classification": (JCls, NomicBertForSequenceClassification,
                           dict(SMALL, **DROP, classifier_dropout=0.25, num_labels=3), "bert_base"),
    }[name]


@pytest.mark.parametrize("name", ["model_postnorm", "model_prenorm", "pretraining", "classification"])
def test_model_replays_jax_masks(name, monkeypatch):
    jcls, tcls, cfg, preset = _model_case(name)
    ids, mask, rng = inputs(3)
    jm = jcls(config=getattr(jpre, preset)(attn_impl="sdpa", **cfg))
    jid, jmask = jnp.asarray(ids), jnp.asarray(mask)
    kw = {}
    if name == "pretraining":
        labels = np.where(rng.random((B, S)) < 0.3, ids, -100).astype(np.int32)
        kw = dict(labels=labels)
    elif name == "classification":
        kw = dict(labels=rng.integers(0, 3, size=B).astype(np.int32))
    params = randomised(jax.jit(jm.init)(jax.random.PRNGKey(0), jid, attention_mask=jmask), 4)
    w = rng.normal(size=(B, S, 64)).astype(np.float32) * mask[:, :, None]

    def j_loss(p):
        out = jm.apply(p, jid, attention_mask=jmask, deterministic=False, rngs={"dropout": KEY},
                       **{k: jnp.asarray(v) for k, v in kw.items()})
        if "loss" in out:
            return out["loss"], out
        return (out["last_hidden_state"] * w).sum(), out

    with jax_masks() as masks:
        _, j_out = j_loss(params)
    j_grads = jax.grad(lambda p: j_loss(p)[0])(params)["params"]
    assert len(masks) >= 2 * 3

    tm = tcls(getattr(tpre, preset)(attn_impl="flash", **cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with replay(masks, monkeypatch):
        out = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                 generator=torch.Generator().manual_seed(0), **tkw)
        loss = out["loss"] if "loss" in out else (out["last_hidden_state"] * torch.from_numpy(w)).sum()
        loss.backward()
    if "loss" in out:
        close(out["loss"], j_out["loss"])
    for key in ("prediction_logits", "logits"):
        if key in out:
            close(out[key], j_out[key])
    if "last_hidden_state" in out:
        close(out["last_hidden_state"] * torch.from_numpy(w), j_out["last_hidden_state"] * w)
    grads_agree(tm, j_grads)


def test_sdpa_replays_jax_masks(monkeypatch):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 12, 2, 64)).astype(np.float32) for _ in range(3))
    mask = (np.arange(12)[None] < np.array([12, 7])[:, None]).astype(np.int32)
    w = rng.normal(size=(2, 12, 2, 64)).astype(np.float32)

    def j_loss(q, k, v):
        out = j_sdpa(q, k, v, attention_mask=jnp.asarray(mask), dropout_p=0.3, dropout_rng=KEY)
        return (out * w).sum(), out

    with jax_masks() as masks:
        _, j_out = j_loss(q, k, v)
    j_grads = jax.grad(lambda *a: j_loss(*a)[0], argnums=(0, 1, 2))(q, k, v)
    assert len(masks) == 1 and masks[0].shape == (2, 2, 12, 12)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with replay(masks, monkeypatch):
        out = sdpa(tq, tk, tv, attention_mask=torch.from_numpy(mask), dropout_p=0.3,
                   dropout_generator=torch.Generator().manual_seed(0))
        (out * torch.from_numpy(w)).sum().backward()
    close(out, j_out)
    for t, g in zip((tq, tk, tv), j_grads):
        close(t.grad, g)


@pytest.mark.parametrize("site", ["embedding", "residual", "classifier"])
def test_rate_one_gives_zeros_as_flax(site, monkeypatch):
    """One site at rate 1.0, the others at 0: flax returns zeros there
    without a draw, and so does the port."""
    over = dict(embedding=dict(embd_pdrop=1.0), residual=dict(resid_pdrop=1.0),
                classifier=dict(classifier_dropout=1.0))[site]
    cfg = dict(SMALL, num_labels=2, **over)
    ids, mask, _ = inputs(6)
    jm = JCls(config=jpre.bert_base(attn_impl="sdpa", **cfg))
    jid, jmask = jnp.asarray(ids), jnp.asarray(mask)
    params = randomised(jax.jit(jm.init)(jax.random.PRNGKey(0), jid, attention_mask=jmask), 8)
    with jax_masks() as masks:
        j_out = jm.apply(params, jid, attention_mask=jmask, deterministic=False, rngs={"dropout": KEY})
    assert masks == []
    tm = NomicBertForSequenceClassification(tpre.bert_base(attn_impl="flash", **cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    no_draws(monkeypatch)
    out = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), generator=torch.Generator())
    close(out["logits"], j_out["logits"])
    if site == "classifier":  # the classifier sees zeros: its bias alone
        close(out["logits"], np.broadcast_to(params["params"]["classifier"]["bias"], (B, 2)))


# -- the port's generators ------------------------------------------------------

def _mlm(remat=False, **over):
    torch.manual_seed(0)
    from contrastors_tpu_torch.models import init_weights

    return init_weights(NomicBertForPreTraining(tpre.nomic_bert_2048(attn_impl="flash", **SMALL, **DROP, **over),
                                                device="cpu", remat=remat), seed=3)


def _mlm_grads(model, seed):
    ids, mask, rng = inputs(9)
    labels = np.where(rng.random((B, S)) < 0.3, ids, -100)
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), labels=torch.from_numpy(labels),
                generator=torch.Generator().manual_seed(seed))
    out["loss"].backward()
    return out["loss"].detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_same_seed_same_noise_other_seed_other_noise():
    model = _mlm()
    a, ga = _mlm_grads(model, 1)
    b, gb = _mlm_grads(model, 1)
    c, _ = _mlm_grads(model, 2)
    assert torch.equal(a, b) and all(torch.equal(ga[n], gb[n]) for n in ga)
    assert not torch.equal(a, c)
    model.eval()
    d, _ = _mlm_grads(model, 1)
    assert not torch.equal(a, d)  # training mode drops


def test_remat_on_and_off_give_bit_identical_gradients_with_dropout():
    off, on = _mlm(remat=False), _mlm(remat=True)
    la, ga = _mlm_grads(off, 4)
    lb, gb = _mlm_grads(on, 4)
    assert torch.equal(la, lb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def test_grad_cache_cached_and_direct_chunks_give_bit_identical_gradients_with_dropout():
    from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
    from contrastors_tpu_torch.losses import clip_loss
    from contrastors_tpu_torch.models.biencoder import LogitScale
    from contrastors_tpu_torch.trainers.text_text import encode_batch

    rng = np.random.default_rng(11)
    q_ids, d_ids = rng.integers(5, 256, size=(8, 10)), rng.integers(5, 256, size=(8, 14))
    qb = {"input_ids": torch.from_numpy(q_ids), "attention_mask": torch.ones(8, 10, dtype=torch.int64)}
    db = {"input_ids": torch.from_numpy(d_ids), "attention_mask": torch.ones(8, 14, dtype=torch.int64)}
    model = BiEncoder(tpre.nomic_bert_2048(attn_impl="flash", **SMALL, **DROP), device="cpu")
    from contrastors_tpu_torch.models import init_weights

    init_weights(model, seed=5)
    scale = LogitScale(20.0, trainable=False, device="cpu")

    def run(direct):
        model.zero_grad(set_to_none=True)
        loss = grad_cache_loss_and_grads(model, qb, db, encode_batch, encode_batch,
                                         lambda q, d: clip_loss(q, d, scale)[0], chunk_size=2, rng=13,
                                         direct_chunks=direct)
        return loss, {n: p.grad.clone() for n, p in model.named_parameters()}

    cached, direct, mixed = run(0), run(-1), run(2)
    for other in (direct, mixed):
        assert torch.equal(cached[0], other[0])
        for name in cached[1]:
            assert torch.equal(cached[1][name], other[1][name]), name
    # an encoder that hides its dropout gets the one direct forward, whose
    # generator draws other noise
    model.uses_dropout = lambda: False
    assert not torch.equal(cached[0], run(-1)[0])


@pytest.mark.parametrize("over", [dict(embd_pdrop=0.1), dict(resid_pdrop=0.1), dict(attn_pdrop=0.1),
                                  dict(prenorm=True, resid_pdrop=0.1)])
def test_training_with_dropout_and_no_generator_raises(over):
    from contrastors_tpu_torch.models import init_weights

    model = init_weights(NomicBertModel(tpre.nomic_bert_2048(attn_impl="flash", **SMALL, **over), device="cpu"), 0)
    ids, mask, _ = inputs(0)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    model.eval()  # eval mode draws nothing and needs none
    model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    cls = NomicBertForSequenceClassification(tpre.bert_base(attn_impl="flash", **SMALL, classifier_dropout=0.1),
                                             device="cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        cls(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))


def test_drop_path_rate_on_the_model_is_ignored_as_in_jax():
    """JAX's NomicBertModel never passes drop_path_rate to its blocks: a
    trunk config with it trains, and its training-mode output is the
    deterministic one."""
    cfg = dict(SMALL, drop_path_rate=0.5)
    ids, mask, _ = inputs(2)
    jm = JModel(config=jpre.nomic_bert_2048(attn_impl="sdpa", **cfg))
    jid, jmask = jnp.asarray(ids), jnp.asarray(mask)
    params = randomised(jax.jit(jm.init)(jax.random.PRNGKey(0), jid, attention_mask=jmask), 10)
    j_out = jm.apply(params, jid, attention_mask=jmask, deterministic=False, rngs={"dropout": KEY})
    tm = NomicBertModel(tpre.nomic_bert_2048(attn_impl="flash", **cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    tm.train()
    out = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))["last_hidden_state"]
    valid = torch.from_numpy(mask)[:, :, None]
    close(out * valid, j_out["last_hidden_state"] * mask[:, :, None])
    assert all(b.drop_path_rate1 == b.drop_path_rate2 == 0.0 for b in tm.layers)


def test_keep_share_and_scale():
    x = torch.ones(1_000_000)
    y = tdrop.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - 0.9) < 6 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.allclose(y[kept], torch.tensor(1 / 0.9))
    assert tdrop.fold_seed(1, 2) != tdrop.fold_seed(2, 1) and tdrop.fold_seed(1, 2) == tdrop.fold_seed(1, 2)


def test_contrastive_step_carries_the_generator_into_the_trunk():
    """text_text.make_train_step with a dropout trunk: the grad-cache step
    with every chunk direct equals the all-cached one bit for bit (grad
    cache asks the BiEncoder whether it draws noise), and the standard
    branch draws (its loss differs from the eval-mode loss)."""
    from contrastors_tpu_torch.models import init_weights
    from contrastors_tpu_torch.models.biencoder import LogitScale
    from contrastors_tpu_torch.trainers.text_text import make_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer

    rng = np.random.default_rng(12)
    qb = {"input_ids": torch.from_numpy(rng.integers(5, 256, size=(8, 10))),
          "attention_mask": torch.ones(8, 10, dtype=torch.int64)}
    db = {"input_ids": torch.from_numpy(rng.integers(5, 256, size=(8, 14))),
          "attention_mask": torch.ones(8, 14, dtype=torch.int64)}

    def run(training=True, **kw):
        model = init_weights(BiEncoder(tpre.nomic_bert_2048(attn_impl="flash", **SMALL, **DROP), device="cpu"), 5)
        model.train(training)
        scale = LogitScale(20.0, trainable=False, device="cpu")
        opt = make_optimizer(model.named_parameters(), 0.0, max_grad_norm=None)
        loss = make_train_step(model, scale, opt, chunk_size=2, **kw)(qb, db, torch.Generator().manual_seed(3))
        return loss["loss"], {n: p.grad for n, p in model.named_parameters()}

    cached, direct = run(direct_chunks_q=0), run(direct_chunks_q=-1, direct_chunks_d=-1)
    assert torch.equal(cached[0], direct[0])
    assert all(torch.equal(cached[1][n], direct[1][n]) for n in cached[1])
    assert not torch.equal(run(grad_cache=False)[0], run(training=False, grad_cache=False)[0])
