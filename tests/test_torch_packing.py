"""The port's sequence packing against the JAX package's.

  - `data/packing.py`: `pack_tokenized`, `packing_efficiency` and
    `packing_kept_fraction` equal JAX's bit for bit (every array, dtype and
    float) on random lengths, over-full geometries and 0-token truncations.
  - The packed BiEncoder (2 layers, n_embd 128, 2 heads of 64, fp32, JAX's
    parameters through `convert.flax_to_torch`): JAX on attn_impl="sdpa",
    the port on "flash" (the kernels' plain versions on CPU tensors), with
    mean pooling on nomic-bert (rotary outside and fused), on bert-base
    (absolute positions), the slot matrix (pair_index=None), and the
    decoder trunk with "last" pooling: embeddings within atol 2e-5. Pad
    positions (segment 0) hold other hidden states in the two packages
    (JAX's SDPA below kv 512 gives them a uniform softmax over all keys, the
    port's kernel 0), so only embeddings and gradients are compared.
  - Packed against padded in the port: the same embeddings within atol
    3e-5 (JAX's `test_packed_matches_padded_embeddings`).
  - The packed standard step with MoE layers and Matryoshka dims, and the
    packed grad cache, against the same objective written with JAX's
    modules: loss within 1e-5 relative, each gradient tensor within 1e-4
    of its largest element; the packed grad cache with embed_parallel (the
    router aux on) bit for bit m = 1's.
  - The trainer through `train.run` with data_args.packed, against JAX's
    `TextTextTrainer` on its 8-device CPU mesh from the same checkpoint:
    the standard branch and grad cache (chunk 4 = one row of K = 4), 32
    pairs a step: losses, grad norms and accuracies of 4 steps within 1e-4
    relative (JAX packs its grad-cache batch per
    device, the port per process: the rows differ, the pairs' embeddings do
    not); and the packed_auto decision on the same first batch, kept and
    refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.data import packing as jpacking
from contrastors_tpu.losses import matryoshka_clip_loss as j_matryoshka, router_aux_loss as j_router_aux_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.model_config import TrunkConfig as JTrunkConfig
from contrastors_tpu.models.presets import bert_base as j_bert, nomic_bert_2048 as j_preset
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.data import packing as tpacking
from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss
from contrastors_tpu_torch.models import BiEncoder, LogitScale
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.presets import bert_base as t_bert, nomic_bert_2048 as t_preset
from contrastors_tpu_torch.trainers.text_text import encode_batch, make_train_step
from contrastors_tpu_torch.utils.optim import make_optimizer

from test_torch_trainer import files, raw_config, read_metrics  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=256)
MOE = dict(SMALL, num_experts=4, moe_top_k=2, moe_every_n_layers=2)


def make_tokenized(rng, B=8, L=48, vocab=250, min_len=5):
    lengths = rng.integers(min_len, L + 1, size=B)
    ids = np.zeros((B, L), np.int64)
    mask = np.zeros((B, L), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(5, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def _full(B, L):
    return np.ones((B, L), np.int64), np.ones((B, L), np.int64)


def _zero_token_with_pad_slot():
    """Rows 0/1 full with free slots, row 2 slot-full with pad room: the
    last 1-token sequence lands with 0 tokens (JAX's test)."""
    ids = np.zeros((5, 8), np.int64)
    mask = np.zeros((5, 8), np.int64)
    for i, n in enumerate([8, 8, 3, 3, 1]):
        ids[i, :n] = np.arange(1, n + 1) + 10 * i
        mask[i, :n] = 1
    return ids, mask


PACK_CASES = {
    "random": (lambda: make_tokenized(np.random.default_rng(0), B=8, L=64), 128, 4),
    "random_tight": (lambda: make_tokenized(np.random.default_rng(1), B=13, L=40), 60, 3),
    "random_int32": (lambda: tuple(a.astype(np.int32) for a in make_tokenized(np.random.default_rng(2), B=9)), 96, 4),
    "overfull": (lambda: _full(6, 64), 100, 3),
    "zero_token_pad_slot": (_zero_token_with_pad_slot, 8, 2),
    "zero_token_all_full": (lambda: _full(4, 4), 4, 2),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_packing_functions_are_jax_bit_for_bit(case):
    make, row_len, K = PACK_CASES[case]
    ids, mask = make()
    want = jpacking.pack_tokenized(ids, mask, row_len=row_len, max_segments=K, pad_id=3)
    got = tpacking.pack_tokenized(ids, mask, row_len=row_len, max_segments=K, pad_id=3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tpacking.packing_efficiency(mask, row_len, K) == jpacking.packing_efficiency(mask, row_len, K)
    kept = tpacking.packing_kept_fraction(ids, mask, row_len, K)
    assert kept == jpacking.packing_kept_fraction(ids, mask, row_len, K)
    if case.startswith("zero_token"):
        slot_tokens = np.array([(got["segment_ids"][p // K] == p % K + 1).sum() for p in got["pair_index"]])
        assert (slot_tokens == 0).any() and kept < 1.0
        if case == "zero_token_pad_slot":  # a 0-token sequence points at a genuine pad slot
            assert (got["segment_ids"].reshape(-1)[got["last_token_index"][slot_tokens == 0]] == 0).all()


def _packed(ids, mask, row_len, K):
    p = tpacking.pack_tokenized(ids, mask, row_len=row_len, max_segments=K)
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


def _decoder_cfg(cls, attn_impl):
    return cls(vocab_size=256, n_positions=0, n_embd=128, n_layer=2, n_head=2, n_inner=256,
               activation_function="gelu", rotary_emb_fraction=0.25, causal=True, pad_token_id=0,
               attn_impl=attn_impl)


ENCODERS = {
    "rotary": (lambda impl, **kw: j_preset(attn_impl=impl, **SMALL, **kw),
               lambda impl, **kw: t_preset(attn_impl=impl, **SMALL, **kw), "encoder", "mean"),
    "absolute": (lambda impl, **kw: j_bert(attn_impl=impl, n_positions=128, **SMALL, **kw),
                 lambda impl, **kw: t_bert(attn_impl=impl, n_positions=128, **SMALL, **kw), "encoder", "mean"),
    "decoder_last": (lambda impl, **kw: _decoder_cfg(JTrunkConfig, impl),
                     lambda impl, **kw: _decoder_cfg(TrunkConfig, impl), "decoder", "last"),
}


@pytest.mark.parametrize("case,fused,slots", [("rotary", False, False), ("rotary", True, False),
                                              ("rotary", False, True), ("absolute", False, False),
                                              ("decoder_last", False, False)])
def test_packed_biencoder_matches_jax(case, fused, slots):
    j_cfg, t_cfg, trunk, pooling = ENCODERS[case]
    ids, mask = make_tokenized(np.random.default_rng(3), B=8, L=40)
    row_len, K = 120, 3
    p, t = _packed(ids, mask, row_len, K)
    jm = JBiEncoder(config=j_cfg("sdpa"), trunk_type=trunk, pooling=pooling)
    jargs = dict(input_ids=jnp.asarray(p["input_ids"]), segment_ids=jnp.asarray(p["segment_ids"]),
                 position_ids=jnp.asarray(p["position_ids"]), last_token_index=jnp.asarray(p["last_token_index"]),
                 pair_index=None if slots else jnp.asarray(p["pair_index"]), max_segments=K)
    params = jm.init(jax.random.PRNGKey(0), **jargs)
    want = np.asarray(jm.apply(params, **jargs)["embedding"])
    tm = BiEncoder(t_cfg("flash", **({"fused_rotary": True} if fused else {})), trunk_type=trunk, pooling=pooling,
                   device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(t["input_ids"], segment_ids=t["segment_ids"], position_ids=t["position_ids"], max_segments=K,
                 pair_index=None if slots else t["pair_index"], last_token_index=t["last_token_index"])["embedding"]
    assert got.shape == want.shape == ((p["input_ids"].shape[0] * K if slots else 8), 128)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    if case == "decoder_last":  # the causal band stays within segments: the padded run's last tokens
        with torch.no_grad():
            padded = tm(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"]
        np.testing.assert_allclose(got.numpy(), padded.numpy(), atol=3e-5, rtol=0)


@pytest.mark.parametrize("case", ["rotary", "absolute"])
def test_packed_matches_padded_embeddings(case):
    _, t_cfg, _, _ = ENCODERS[case]
    tm = BiEncoder(t_cfg("flash"), device="cpu")
    ids, mask = make_tokenized(np.random.default_rng(4), B=8, L=48)
    _, t = _packed(ids, mask, 4 * 48, 4)  # room for any 4: nothing truncated
    with torch.no_grad():
        padded = tm(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"]
        packed = tm(t["input_ids"], segment_ids=t["segment_ids"], position_ids=t["position_ids"], max_segments=4,
                    pair_index=t["pair_index"])["embedding"]
    np.testing.assert_allclose(packed.numpy(), padded.numpy(), atol=3e-5, rtol=0)


def test_zero_token_slots_embed_to_zero_under_last_pooling():
    """Every row full: no pad slot anywhere, so a 0-token sequence's index
    aliases its row's last token, and the pooling zeroes it (as JAX's)."""
    ids, mask = _full(4, 4)
    p, t = _packed(ids, mask, 4, 2)
    jm = JBiEncoder(config=_decoder_cfg(JTrunkConfig, "sdpa"), trunk_type="decoder", pooling="last")
    jargs = dict(input_ids=jnp.asarray(p["input_ids"]), segment_ids=jnp.asarray(p["segment_ids"]),
                 position_ids=jnp.asarray(p["position_ids"]), pair_index=jnp.asarray(p["pair_index"]),
                 last_token_index=jnp.asarray(p["last_token_index"]), max_segments=2, normalize=False)
    params = jm.init(jax.random.PRNGKey(0), **jargs)
    want = np.asarray(jm.apply(params, **jargs)["embedding"])
    tm = BiEncoder(_decoder_cfg(TrunkConfig, "flash"), trunk_type="decoder", pooling="last", device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(t["input_ids"], segment_ids=t["segment_ids"], position_ids=t["position_ids"], max_segments=2,
                 pair_index=t["pair_index"], last_token_index=t["last_token_index"], normalize=False)["embedding"]
    empty = np.array([(p["segment_ids"][i // 2] == i % 2 + 1).sum() == 0 for i in p["pair_index"]])
    assert empty.any() and (got.numpy()[empty] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_packed_mode_refuses_what_jax_refuses():
    t = {k: torch.from_numpy(v) for k, v in tpacking.pack_tokenized(*_full(4, 4), 8, 2).items()}
    kw = dict(segment_ids=t["segment_ids"], position_ids=t["position_ids"], max_segments=2)
    with pytest.raises(ValueError, match="mean or last"):
        BiEncoder(t_preset(attn_impl="flash", **SMALL), pooling="cls", device="cpu")(t["input_ids"], **kw)
    with pytest.raises(ValueError, match="last_token_index"):
        BiEncoder(_decoder_cfg(TrunkConfig, "flash"), trunk_type="decoder", pooling="last",
                  device="cpu")(t["input_ids"], **kw)
    vit = BiEncoder(t_preset(attn_impl="flash", **SMALL), device="cpu")
    vit.trunk_type = "vision"
    with pytest.raises(ValueError, match="vision"):
        vit(t["input_ids"], **kw)


# ---- the packed steps against the same objective in JAX -------------------

@pytest.fixture(scope="module")
def moe_pairs():
    """Packed query / document rows of 12 pairs, JAX's MoE BiEncoder and its
    parameters (fp32, LogitScale 20 fixed)."""
    rng = np.random.default_rng(5)
    q_ids, q_mask = make_tokenized(rng, B=12, L=16)
    d_ids, d_mask = make_tokenized(rng, B=12, L=32)
    d_ids[:, :4] = q_ids[:, :4]
    qp = tpacking.pack_tokenized(q_ids, q_mask, 32, 3)
    dp = tpacking.pack_tokenized(d_ids, d_mask, 64, 3)
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **MOE), pooling="mean")
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), input_ids=jnp.ones((2, 8), jnp.int32),
                              attention_mask=jnp.ones((2, 8), jnp.int32))
    return qp, dp, jm, params


def _j_encode(jm, p, b, slots=False):
    out = jm.apply(p, input_ids=b["input_ids"], segment_ids=b["segment_ids"], position_ids=b["position_ids"],
                   pair_index=None if slots else b["pair_index"], max_segments=3)
    aux = j_router_aux_loss(out["router_logits"], 4, 2, attention_mask=(b["segment_ids"] > 0).astype(jnp.int32))
    return out["embedding"], aux


def _port(params):
    tm = BiEncoder(t_preset(attn_impl="flash", **MOE), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    scale = LogitScale(20.0, trainable=False, device="cpu")
    return tm, scale


def _assert_grads_close(got, want, rtol=1e-4):
    assert got.keys() == want.keys()
    for n in want:
        ref = torch.as_tensor(np.asarray(want[n]))
        torch.testing.assert_close(got[n], ref, rtol=0, atol=rtol * ref.abs().max().item(), msg=n)


def test_packed_standard_step_with_moe_and_matryoshka_matches_jax(moe_pairs):
    qp, dp, jm, params = moe_pairs
    dims, weights, coef = [128, 64], [1.0, 0.5], 0.01
    jq, jd = ({k: jnp.asarray(v) for k, v in b.items()} for b in (qp, dp))

    def objective(p):
        (q, aq), (d, ad) = _j_encode(jm, p, jq), _j_encode(jm, p, jd)
        loss, _ = j_matryoshka(q, d, lambda x: x * 20.0, dims=dims, weights=weights)
        return loss + coef * (aq + ad)

    j_loss, j_grads = jax.jit(jax.value_and_grad(objective))(params)
    tm, scale = _port(params)
    named = [("model." + n, p) for n, p in tm.named_parameters()]
    opt = make_optimizer(named, 0.0, weight_decay=0.0, max_grad_norm=1e9)
    step = make_train_step(tm, scale, opt, grad_cache=False, matryoshka_dims=dims, matryoshka_loss_weights=weights,
                           router_aux_coef=coef, packed_segments=3)
    m = step(*({k: torch.from_numpy(v) for k, v in b.items()} for b in (qp, dp)))
    np.testing.assert_allclose(m["loss"].item(), float(j_loss), rtol=1e-5)
    _assert_grads_close({n: p.grad for n, p in tm.named_parameters()}, flax_to_torch(j_grads))


def test_packed_grad_cache_matches_jax(moe_pairs):
    """Rows as chunks (2 query rows, 1 document row: chunk 6 // K 3 = 2 and
    a chunk_size_d of 3 // 3 = 1), the slot matrices gathered at the loss,
    the router aux summed per chunk, against JAX's grad cache on the same
    rows with the pairs gathered the same way."""
    qp, dp, jm, params = moe_pairs
    coef = 0.01
    keys = ("input_ids", "segment_ids", "position_ids")
    jq, jd = ({k: jnp.asarray(b[k]) for k in keys} for b in (qp, dp))
    q_idx, d_idx = jnp.asarray(qp["pair_index"]), jnp.asarray(dp["pair_index"])

    def encode(p, b, _rng):
        emb, aux = _j_encode(jm, p, b, slots=True)
        return {"embedding": emb, "router_aux": aux}

    from contrastors_tpu.grad_cache import grad_cache_loss_and_grads as j_grad_cache
    from contrastors_tpu.losses import clip_loss as j_clip

    j_loss, j_grads = jax.jit(lambda p: j_grad_cache(
        p, jq, jd, encode, encode, lambda q, d: j_clip(q[q_idx], d[d_idx], lambda x: x * 20.0)[0],
        chunk_size=2, chunk_size_d=1, router_aux_coef=coef))(params)
    tm, scale = _port(params)
    tq, td = ({k: torch.from_numpy(b[k]) for k in keys} for b in (qp, dp))
    tq_idx, td_idx = torch.from_numpy(qp["pair_index"]).long(), torch.from_numpy(dp["pair_index"]).long()
    encode_packed = lambda model, b, gen, **kw: encode_batch(model, b, gen, max_segments=3, **kw)  # noqa: E731
    loss = grad_cache_loss_and_grads(
        tm, tq, td, encode_packed, encode_packed,
        lambda q, d, s: clip_loss(q[tq_idx], d[td_idx], s)[0], chunk_size=2, chunk_size_d=1,
        extra_params=scale, router_aux_coef=coef)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _assert_grads_close({n: p.grad for n, p in tm.named_parameters()}, flax_to_torch(j_grads))


def test_packed_grad_cache_embed_parallel_is_m1_bit_for_bit(moe_pairs):
    """Pass 1 over packed row chunks, 2 a forward for the queries and 3 for
    the documents, with the router aux on: m = 1's loss and gradients bit
    for bit."""
    qp, dp, _, params = moe_pairs
    keys = ("input_ids", "segment_ids", "position_ids")
    tq, td = ({k: torch.from_numpy(b[k]) for k in keys} for b in (qp, dp))
    tq_idx, td_idx = torch.from_numpy(qp["pair_index"]).long(), torch.from_numpy(dp["pair_index"]).long()
    encode_packed = lambda model, b, gen, **kw: encode_batch(model, b, gen, max_segments=3, **kw)  # noqa: E731
    runs = []
    for m, md in ((1, 1), (2, 3)):
        tm, scale = _port(params)
        loss = grad_cache_loss_and_grads(
            tm, tq, td, encode_packed, encode_packed, lambda q, d, s: clip_loss(q[tq_idx], d[td_idx], s)[0],
            chunk_size=1, chunk_size_d=1, extra_params=scale, router_aux_coef=0.01, embed_parallel=m,
            embed_parallel_d=md)
        runs.append((loss, {n: p.grad for n, p in tm.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])


# ---- the trainer through train.run, against JAX's trainer -----------------

# 32 pairs a step: 8 rows of K = 4, one row for each device of JAX's mesh
PACKED_STEPS = 4
PACKED_CASES = {
    "packed_standard": dict(train=dict(grad_cache=False), data=dict(packed=True, packed_seq_len=32)),
    "packed_grad_cache": dict(train=dict(grad_cache=True, chunk_size=4),
                              data=dict(packed=True, packed_auto=True, packed_seq_len=32)),
}


def _packed_config(files, out, case):
    spec = PACKED_CASES[case]
    raw = raw_config(files, out, "grad_cache", num_train_steps=PACKED_STEPS, **spec["train"])
    raw["data_args"].update(spec["data"], batch_size=32)
    return raw


@pytest.fixture(scope="module")
def packed_runs(files):  # noqa: F811
    runs = {}
    for case in PACKED_CASES:
        j_out, t_out = str(files["tmp"] / f"jax_{case}"), str(files["tmp"] / f"port_{case}")
        jt = J_REGISTRY["encoder"](JConfig(**_packed_config(files, j_out, case)), "fp32")
        start = jax.device_get(jt.params)
        jt.train()
        pt = ttrain.run(Config.from_dict(_packed_config(files, t_out, case)), "fp32", "cpu",
                        trainer_cls=_starting_at({f"{part}.{k}": v for part in ("model", "logit_scale")
                                                  for k, v in flax_to_torch(start[part]).items()}))
        runs[case] = (jt, read_metrics(j_out), pt, read_metrics(t_out))
    return runs


def _starting_at(state):
    from contrastors_tpu_torch.trainers import TextTextTrainer

    class Start(TextTextTrainer):
        def get_model(self):
            model = super().get_model()
            model.load_state_dict(state, strict=True)
            return model

    return Start


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_trainer_logs_jax_losses(case, packed_runs):
    jt, jm, pt, tm = packed_runs[case]
    assert jt.config.data_args.packed and pt.config.data_args.packed  # packed_auto kept packing on both
    jm, tm = ([m for m in ms if "loss" in m] for ms in (jm, tm))
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == list(range(1, PACKED_STEPS + 1))
    for key in ("loss", "grad_norm", "accuracy/local"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], rtol=1e-4, err_msg=key)
    assert {k for m in tm for k in m} == {k for m in jm for k in m}
    assert tm[-1]["loss"] < tm[0]["loss"]


@pytest.mark.parametrize("seq_len,kept", [(32, True), (None, False), (12, False)],
                         ids=["gain", "no_gain", "truncates"])
def test_packed_auto_decides_as_jax_on_the_first_batch(packed_runs, seq_len, kept):
    """The default geometry (128-token rows for 16-token texts) gains 0.5x
    and 12-token rows truncate: both refused; 32-token rows kept. The
    standard branch's trainers: JAX packs its grad-cache batches per
    device."""
    jt, _, pt, _ = packed_runs["packed_standard"]
    batch = next(iter(pt.dataloader))
    outs = []
    for trainer in (jt, pt):
        dargs = trainer.config.data_args
        trainer._packed_decided = False
        dargs.packed, dargs.packed_auto, dargs.packed_seq_len = True, True, seq_len
        try:
            outs.append(trainer.transform_host_batch(dict(batch)))
            assert dargs.packed == kept
        finally:
            dargs.packed, dargs.packed_auto, dargs.packed_seq_len = True, False, 32
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        if isinstance(outs[0][k], np.ndarray):
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    assert ("query_pair_index" in outs[1]) == kept
