"""What each rank runs for tests/test_torch_moe_data_axis.py (through
tests/torch_dist_worker.py): the port's capacity and expert-choice MoE
dispatch on a mesh of data x expert gloo ranks, in fp32, at factors that
drop. The test writes the layout to <workdir>/layout.json and JAX's
parameters beside it; the inputs come from numpy generators with fixed
seeds, which the test process rebuilds for JAX. No JAX here."""

import contextlib

import numpy as np
import torch

from contrastors_tpu_torch.parallel.collectives import all_reduce_sum
from contrastors_tpu_torch.parallel.sharding import shard_module

from torch_parallel_cases import _global_step, _load, mesh_of, proj, rows

# tests/test_expert_parallel.py's _moe_cfg
CFG = dict(n_embd=32, n_layer=2, n_head=2, n_inner=64, vocab_size=128, pad_token_id=0, n_positions=32,
           activation_function="swiglu", num_experts=4, moe_top_k=2, moe_every_n_layers=2, type_vocab_size=0)
B, S = 8, 8
# (dispatch, capacity factor): every one drops
ROUTES = [("capacity", 1.0), ("capacity", 0.5), ("expert_choice", 1.0), ("expert_choice", 0.5)]
GC_B, GC_LQ, GC_LD, GC_CHUNK, SCALE = 16, 6, 10, 4, 20.0
ENC_TEXTS = 16


def route_cfg(dispatch, factor):
    return dict(CFG, moe_impl="capacity", moe_capacity_factor=factor,
                expert_choice_router=dispatch == "expert_choice")


def ids_and_mask():
    """The global batch: padded rows (every row keeps >= 3 tokens)."""
    rng = np.random.default_rng(4)
    ids = rng.integers(5, 120, size=(B, S))
    mask = (np.arange(S)[None] < rng.integers(3, S + 1, size=B)[:, None]).astype(np.int64)
    return ids, mask


def gc_batches():
    rng = np.random.default_rng(6)
    q = rng.integers(5, 120, size=(GC_B, GC_LQ))
    d = rng.integers(5, 120, size=(GC_B, GC_LD))
    d[:, :GC_LQ] = q
    d_mask = (np.arange(GC_LD)[None] < rng.integers(GC_LQ, GC_LD + 1, size=GC_B)[:, None]).astype(np.int64)
    return ({"input_ids": q, "attention_mask": np.ones_like(q)}, {"input_ids": d, "attention_mask": d_mask})


def enc_texts():
    rng = np.random.default_rng(7)
    return [" ".join(str(int(w)) for w in rng.integers(5, 120, size=rng.integers(2, 12))) for _ in range(ENC_TEXTS)]


def trunk(cfg):
    from contrastors_tpu_torch.models.model_config import TrunkConfig
    from contrastors_tpu_torch.models.nomic_bert import NomicBertModel

    return NomicBertModel(TrunkConfig(attn_impl="sdpa", **cfg), device="cpu").eval()


def biencoder(cfg):
    from contrastors_tpu_torch.models.biencoder import BiEncoder
    from contrastors_tpu_torch.models.model_config import TrunkConfig

    return BiEncoder(TrunkConfig(attn_impl="sdpa", **cfg), pooling="mean", device="cpu").eval()


def dropped(model, mesh, run):
    """run() under a reader of every MoE layer's routing: the global share
    of valid tokens' assignments that no slot took (capacity), or of valid
    tokens that no expert picked (expert choice; read where a rank holds
    every expert, else None)."""
    from contrastors_tpu_torch.layers.moe import MoEMLP

    counts = []
    orig_slots, orig_combine = MoEMLP._capacity_slots, MoEMLP._combine

    def slots(self, top_e, valid, groups, dp):
        out = orig_slots(self, top_e, valid, groups, dp)
        live = valid.sum() * self.top_k
        counts.append(torch.stack([live - out[-1].sum(), live]).float())
        return out

    def combine(self, x_rows, idx, weights, n_out):
        if self.config.expert_choice_router and self.ep is None:
            valid = self.valid_.reshape(-1)
            picked = torch.zeros(n_out, dtype=torch.bool).index_fill(0, idx.reshape(-1), True)[:valid.shape[0]]
            counts.append(torch.stack([(valid & ~picked).sum(), valid.sum()]).float())
        return orig_combine(self, x_rows, idx, weights, n_out)

    def forward(self, h, attention_mask=None, groups=1):
        self.valid_ = torch.ones(h.shape[:2], dtype=torch.bool) if attention_mask is None else attention_mask.bool()
        return orig_forward(self, h, attention_mask, groups)

    orig_forward = MoEMLP.forward
    MoEMLP._capacity_slots, MoEMLP._combine, MoEMLP.forward = slots, combine, forward
    try:
        result = run()
    finally:
        MoEMLP._capacity_slots, MoEMLP._combine, MoEMLP.forward = orig_slots, orig_combine, orig_forward
    if not counts:
        return result, None
    total = all_reduce_sum(torch.stack(counts).sum(dim=0), mesh.group)
    return result, float(total[0] / total[1])


def standard(rank, world, workdir):
    """JAX's standard step form: mean(h * w) over the global batch and its
    whole gradients, for each route, routed over the data axis and, as a
    fault, routed per rank (`local_routing`)."""
    from contrastors_tpu_torch.layers.moe import local_routing

    mesh = mesh_of(workdir)
    ids, mask = (torch.from_numpy(rows(a, mesh)) for a in ids_and_mask())
    w = torch.from_numpy(rows(proj((B, S, CFG["n_embd"])), mesh))
    state = _load(workdir, "moe.pt")
    out = {}
    for dispatch, factor in ROUTES:
        for mode in ("data", "per_rank"):
            model = trunk(route_cfg(dispatch, factor))
            model.load_state_dict(state, strict=True)
            shard_module(model, mesh)

            def run():
                with local_routing() if mode == "per_rank" else contextlib.nullcontext():
                    return _global_step(model, mesh, (model(ids, mask)["last_hidden_state"] * w).mean())

            (loss, grads), share = dropped(model, mesh, run)
            out[(dispatch, factor, mode)] = {"loss": loss, "grads": grads, "dropped": share}
    return out


def encoder(rank, world, workdir):
    """The mesh Encoder: every rank gets the whole batch's embeddings."""
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer

    mesh = mesh_of(workdir)
    out = {}
    for dispatch, factor in ROUTES:
        model = biencoder(route_cfg(dispatch, factor))
        model.load_state_dict(_load(workdir, "moe_bi.pt"), strict=True)
        enc = Encoder(model, StubTokenizer(CFG["vocab_size"]), seq_len=16, batch_size=8, query_prefix=None,
                      document_prefix=None, mesh=mesh)
        out[(dispatch, factor)] = enc.encode(enc_texts())
    return out


def grad_cache(rank, world, workdir):
    """Grad cache over the data group (this rank's rows, chunk GC_CHUNK a
    rank, pass 1 at embed_parallel 1 and 2) with clip_loss: the global
    loss and the whole gradients."""
    from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
    from contrastors_tpu_torch.losses import clip_loss
    from contrastors_tpu_torch.parallel.sharding import gather_tensors, param_splits

    mesh = mesh_of(workdir)
    qb, db = ({k: torch.from_numpy(rows(v, mesh)) for k, v in b.items()} for b in gc_batches())

    def encode(m, b, gen=None, chunks=1):
        return {"embedding": m(b["input_ids"], b["attention_mask"], moe_groups=chunks)["embedding"]}

    def loss_fn(q, d):
        return clip_loss(q, d, lambda x: x * SCALE, group=mesh.group)[0]

    out = {}
    for dispatch, factor in ROUTES:
        for m in (1, 2):
            model = biencoder(route_cfg(dispatch, factor))
            model.load_state_dict(_load(workdir, "moe_bi.pt"), strict=True)
            shard_module(model, mesh)
            loss = grad_cache_loss_and_grads(model, qb, db, encode, encode, loss_fn, chunk_size=GC_CHUNK,
                                             embed_parallel=m, group=mesh.group)
            grads = gather_tensors({n: p.grad for n, p in model.named_parameters()}, param_splits(model), mesh)
            out[(dispatch, factor, m)] = {"loss": float(loss), "grads": grads}
    return out


def at(layouts, fn):
    from torch_parallel_cases import layout

    def case(rank, world, workdir):
        return fn(rank, world, workdir) if layout(workdir) in layouts else None
    return case


DATA, DATA_EXPERT = (2, 1, 1), (2, 2, 1)
CASES = {
    "standard": standard,
    "encoder": at((DATA,), encoder),
    "grad_cache": grad_cache,
}
