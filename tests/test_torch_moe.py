"""The port's dropless MoE layer, blocks, model and router loss against
the JAX package's.

Small sizes: n_embd 128, 4 experts, top-2 (with one shared expert: 3
routed, top-1 routed), swiglu, on fp32 parameters converted by
`convert.flax_to_torch` with strict=True. The JAX side runs the dropless
dispatch (`jax.lax.ragged_dot` off the TPU, the Pallas gmm's semantics);
the port runs its plain grouped matmul on CPU tensors. Both sides route
the same fp32 logits, so they pick the same experts (`torch.topk` and
`jax.lax.top_k` differ only on exact ties, which random inputs avoid).
Tolerances, fp32:
  - MoEMLP output and masked router logits (-1e9 on padding): atol 1e-5;
  - MoE blocks (postnorm, prenorm): atol 1e-5;
  - a 4-layer MoE BiEncoder (JAX on sdpa attention, the port on its plain
    flash): embedding cosine >= 0.99999 and max abs <= 1e-5, router
    logits atol 1e-4 (the flash path zeroes padded query rows, so only the
    masked logits are compared);
  - router_aux_loss: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers.block import Block as JBlock
from contrastors_tpu.layers.moe import MoEMLP as JMoEMLP
from contrastors_tpu.losses import router_aux_loss as j_router_aux_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.layers.moe import MoEMLP
from contrastors_tpu_torch.losses import router_aux_loss
from contrastors_tpu_torch.models import BiEncoder, init_weights
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset

MOE = dict(n_layer=4, n_embd=128, n_head=2, n_inner=256, vocab_size=512,
           num_experts=4, moe_top_k=2, moe_every_n_layers=2)
B, S = 3, 20


def _mask():
    lengths = np.array([S, 13, 6])
    return (np.arange(S)[None] < lengths[:, None]).astype(np.int32)


def _randomise(variables, seed):
    """The flax params plus N(0, 0.02) noise (non-zero biases), fp32."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.02, size=x.shape)).astype(np.float32),
        variables["params"],
    )


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_mlp_matches_jax(shared):
    cfg = dict(MOE, num_shared_experts=shared)
    x = np.random.default_rng(0).normal(size=(B, S, 128)).astype(np.float32)
    mask = _mask()
    jm = JMoEMLP(config=j_preset(**cfg))
    params = _randomise(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                         attention_mask=jnp.asarray(mask)), 1)
    j_out, j_logits = jm.apply({"params": params}, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    tm = MoEMLP(t_preset(**cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        t_out, t_logits = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=0)
    assert (t_logits.numpy()[~mask.reshape(-1).astype(bool)] == -1e9).all()


@pytest.mark.parametrize("prenorm", [False, True])
def test_moe_block_matches_jax(prenorm):
    cfg = dict(MOE, prenorm=prenorm)
    x = np.random.default_rng(2).normal(size=(B, S, 128)).astype(np.float32)
    mask = _mask()
    jb = JBlock(config=j_preset(**cfg), moe=True)
    params = _randomise(jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x), None, jnp.asarray(mask)), 3)
    jh, jres, jrl = jb.apply({"params": params}, jnp.asarray(x), None, jnp.asarray(mask))
    tb = Block(t_preset(**cfg), moe=True, device="cpu")
    tb.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        th, tres, trl = tb(torch.from_numpy(x), None, torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(trl.numpy(), np.asarray(jrl), atol=1e-5, rtol=0)
    if prenorm:
        np.testing.assert_allclose(tres.numpy()[valid], np.asarray(jres)[valid], atol=1e-5, rtol=0)


def _biencoders(**over):
    cfg = dict(MOE, **over)
    ids = np.random.default_rng(4).integers(1, 512, size=(B, S)) * _mask()
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **cfg), pooling="mean")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids),
                                 attention_mask=jnp.asarray(_mask()))
    tm = BiEncoder(t_preset(attn_impl="flash", **cfg), pooling="mean", device="cpu")
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    return jm, variables, tm, ids


def test_moe_biencoder_matches_jax():
    jm, variables, tm, ids = _biencoders()
    mask = _mask()
    j = jm.apply(variables, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        t = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    je, te = np.asarray(j["embedding"], np.float64), t["embedding"].double().numpy()
    cos = (je * te).sum(-1) / np.linalg.norm(je, axis=-1) / np.linalg.norm(te, axis=-1)
    assert cos.min() >= 0.99999
    assert np.abs(je - te).max() <= 1e-5
    assert len(t["router_logits"]) == len(j["router_logits"]) == 2  # layers 1 and 3
    for tl, jl in zip(t["router_logits"], j["router_logits"]):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_dense_biencoder_has_no_router_logits():
    tm = BiEncoder(t_preset(**dict(MOE, num_experts=0)), device="cpu")
    ids = torch.ones(2, 8, dtype=torch.int64)
    assert tm(ids, torch.ones_like(ids))["router_logits"] is None


@pytest.mark.parametrize("masked", [True, False])
def test_router_aux_loss_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = [rng.normal(size=(B * S, 4)).astype(np.float32) for _ in range(3)]
    mask = _mask() if masked else None
    j = j_router_aux_loss([jnp.asarray(x) for x in logits], 4, 2,
                          attention_mask=None if mask is None else jnp.asarray(mask))
    t = router_aux_loss([torch.from_numpy(x) for x in logits], 4, 2,
                        attention_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-6, atol=1e-6)


def test_router_aux_loss_is_top_k_when_balanced():
    # every expert equally likely and equally chosen: 2.0 for top-2
    logits = torch.zeros(8, 4)
    logits[torch.arange(8), torch.arange(8) % 4] = 1.0
    logits[torch.arange(8), (torch.arange(8) + 1) % 4] = 0.5
    torch.testing.assert_close(router_aux_loss([logits], 4, 2), torch.tensor(2.0))


def test_convert_loads_a_jax_moe_tree_with_shared_experts():
    """A JAX MoE BiEncoder with a shared expert loads with strict=True: the
    router and 3-D expert tensors as they are, the shared Dense kernels
    transposed. init_weights gives the MoE parameters the JAX initialisers'
    kinds: normal for the router and experts, zero for the bias."""
    jm, variables, tm, ids = _biencoders(num_shared_experts=1)
    sd = flax_to_torch(variables)
    layer = variables["params"]["trunk"]["layers_1"]["mlp"]
    np.testing.assert_array_equal(sd["trunk.layers.1.mlp.shared_up.weight"].numpy(),
                                  np.asarray(layer["shared_up"]["kernel"]).T)
    np.testing.assert_array_equal(sd["trunk.layers.1.mlp.w_up"].numpy(), np.asarray(layer["w_up"]))
    assert tuple(sd["trunk.layers.1.mlp.router"].shape) == (128, 3)
    init_weights(tm, seed=0)
    mlp = tm.trunk.layers[1].mlp
    for p in (mlp.router, mlp.w_up, mlp.w_gate, mlp.w_down):
        assert 0.015 < p.std().item() < 0.025
    assert bool((mlp.bias == 0).all())


@pytest.mark.parametrize("over,err", [
    (dict(moe_impl="capacity"), NotImplementedError),
    (dict(expert_choice_router=True), NotImplementedError),
    (dict(moe_impl="auto"), ValueError),
])
def test_unported_moe_options_raise(over, err):
    with pytest.raises(err):
        MoEMLP(t_preset(**MOE, **over), device="cpu")
