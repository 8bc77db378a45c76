"""What each rank runs for tests/test_torch_tensor_parallel.py and
tests/test_torch_expert_parallel.py (through tests/torch_dist_worker.py):
the port on a mesh of data x expert x tensor gloo ranks, in fp32. The test
writes the layout to <workdir>/layout.json and the inputs it shares with
JAX (state dicts converted from JAX's parameters, file paths) beside it;
each case runs at the layouts it names and returns None at the others.
Model inputs come from numpy generators with fixed seeds, which the test
process rebuilds for JAX from the same functions. No JAX here."""

import json
import os
import random

import numpy as np
import torch

from contrastors_tpu_torch.parallel import all_reduce_grads, make_mesh
from contrastors_tpu_torch.parallel.collectives import reduce_metrics
from contrastors_tpu_torch.parallel.sharding import gather_state_dict, gather_tensors, param_splits, shard_module

# tests/test_tensor_parallel.py's model and batch
TP_CFG = dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_inner=128)
TP_B, TP_S = 8, 16
TP_SCALE = 20.0
# tests/test_expert_parallel.py's _moe_cfg and batch
EP_CFG = dict(n_embd=32, n_layer=2, n_head=2, n_inner=64, vocab_size=128, pad_token_id=0, n_positions=32,
              activation_function="swiglu", num_experts=4, moe_top_k=2, moe_every_n_layers=2, type_vocab_size=0)
# tests/test_tensor_parallel.py's test_tp_with_expert_axis_moe config
EPTP_CFG = dict(n_embd=32, n_layer=2, n_head=2, n_inner=64, vocab_size=64, pad_token_id=0, n_positions=32,
                activation_function="swiglu", num_experts=4, moe_top_k=2, moe_every_n_layers=2)
STEPS = 3


def layout(workdir):
    with open(os.path.join(workdir, "layout.json")) as f:
        return tuple(json.load(f))


def mesh_of(workdir):
    d, e, t = layout(workdir)
    return make_mesh(data=d, tensor=t, expert=e)


def tp_batch():
    rng = np.random.default_rng(0)
    q = rng.integers(5, 250, size=(TP_B, TP_S))
    d = rng.integers(5, 250, size=(TP_B, TP_S))
    return q, d


def ep_ids(seed):
    return np.random.default_rng(seed).integers(5, 120 if seed == 0 else 60, size=(8, 8))


def vit_pixels():
    return np.random.default_rng(8).normal(size=(3, 3, 32, 32)).astype(np.float32)


def vit_weights():
    return np.random.default_rng(9).normal(size=(3, 64)).astype(np.float32)


def lm_ids():
    return np.random.default_rng(1).integers(1, 128, size=(2, 12))


def proj(shape, seed=11):
    """The fixed weights w of the losses mean(h * w) over hidden states (a
    normed h makes mean(h^2) a constant, whose gradient is rounding)."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def rows(x, mesh):
    n = x.shape[0] // mesh.data
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def _load(workdir, name):
    return torch.load(os.path.join(workdir, name), weights_only=False)


def _grads(model, mesh):
    """The whole gradients (gathered over the model groups), by name."""
    named = {n: p.grad for n, p in model.named_parameters()}
    return gather_tensors(named, param_splits(model), mesh)


# -- the models of the comparisons --------------------------------------------
def tp_model(train=False, remat=False, **over):
    from contrastors_tpu_torch.models.biencoder import BiEncoder
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    model = BiEncoder(nomic_bert_2048(attn_impl="sdpa", **dict(TP_CFG, **over)), pooling="mean", device="cpu",
                      remat=remat)
    return model.train(train)


def moe_model(cfg, moe_impl):
    from contrastors_tpu_torch.models.model_config import TrunkConfig
    from contrastors_tpu_torch.models.nomic_bert import NomicBertModel

    return NomicBertModel(TrunkConfig(attn_impl="sdpa", moe_impl=moe_impl, **cfg), device="cpu").eval()


def open_lm_model(hf_cfg):
    from contrastors_tpu_torch.models import hf_interop_decoder as dec
    from contrastors_tpu_torch.models.decoder import DecoderModel

    return DecoderModel(dec.open_lm_config_to_trunk_config(hf_cfg, attn_impl="sdpa"), device="cpu").eval()


def vit_model(cfg_kw):
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config

    cfg = timm_name_to_trunk_config("vit_eva02_base_patch16_224", attn_impl="sdpa", **cfg_kw)
    return BiEncoder(cfg, trunk_type="vision", pooling="map", device="cpu").eval()


def neox_model(hf_cfg):
    from contrastors_tpu_torch.models import hf_interop_decoder as dec
    from contrastors_tpu_torch.models.decoder import DecoderModel

    return DecoderModel(dec.decoder_config_to_trunk_config(hf_cfg, attn_impl="sdpa"), device="cpu")


# -- the rank's side of each comparison ---------------------------------------
def _tp_loss(model, mesh, q, d):
    """This data rank's share of clip_loss on the global batch (its rows'
    queries against every rank's documents)."""
    from contrastors_tpu_torch.losses import clip_loss

    qe = model(torch.from_numpy(rows(q, mesh)), torch.ones((q.shape[0] // mesh.data, TP_S), dtype=torch.long))
    de = model(torch.from_numpy(rows(d, mesh)), torch.ones((d.shape[0] // mesh.data, TP_S), dtype=torch.long))
    loss, _ = clip_loss(qe["embedding"], de["embedding"], lambda x: x * TP_SCALE, group=mesh.group)
    return loss


def _global_step(model, mesh, loss):
    """The global loss and the whole gradients of the global loss."""
    (loss / mesh.data).backward()
    all_reduce_grads(list(model.parameters()), mesh.group)
    return float(reduce_metrics({"loss": loss.detach()}, mesh.group)["loss"]), _grads(model, mesh)


def tp_bert(rank, world, workdir):
    """The TP test model with clip_loss at this layout, from JAX's
    parameters: the global loss, the whole gradients, and the local
    shapes of a split layer."""
    mesh = mesh_of(workdir)
    model = tp_model()
    model.load_state_dict(_load(workdir, "tp_bert.pt"), strict=True)
    plan = shard_module(model, mesh)
    q, d = tp_batch()
    loss, grads = _global_step(model, mesh, _tp_loss(model, mesh, q, d))
    attn = model.trunk.layers[0].attn
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return {"loss": loss, "grads": grads, "plan": sorted(plan), "shapes": shapes,
            "heads": (attn.tp.size, attn.tp.rank)}


def tp_faults(rank, world, workdir):
    """The TP model with biases on every projection (seeded, biases drawn
    away from 0): the whole model's loss and gradients in this process,
    the split run's, and the split run's with one planted fault each: the
    row split's bias added on every rank before the sum, and
    copy_to_group's backward all-reduce dropped."""
    from contrastors_tpu_torch.layers import dense as dense_mod
    from contrastors_tpu_torch.parallel import collectives as coll
    from contrastors_tpu_torch.parallel.mesh import Mesh

    mesh = mesh_of(workdir)
    q, d = tp_batch()
    biases = dict(qkv_proj_bias=True, mlp_fc1_bias=True, mlp_fc2_bias=True)
    torch.manual_seed(5)
    state = {k: v + 0.05 * torch.randn_like(v) if k.endswith("bias") else v
             for k, v in tp_model(**biases).state_dict().items()}

    def build():
        model = tp_model(**biases)
        model.load_state_dict(state, strict=True)
        return model

    whole = build()
    loss = _tp_loss(whole, Mesh(), q, d)
    loss.backward()
    out = {"whole": {"loss": float(loss), "grads": {n: p.grad for n, p in whole.named_parameters()}}}

    def bias_every_rank(self, x):
        if self.split == "row":
            return coll.reduce_from_group(self.local(x), self.group)
        return real_forward(self, x)

    real_forward, real_copy = dense_mod.Dense.forward, coll._CopyToGroup.__dict__["backward"]
    for case in ("split", "row_bias_every_rank", "copy_without_all_reduce"):
        model = build()
        shard_module(model, mesh)
        if case == "row_bias_every_rank":
            dense_mod.Dense.forward = bias_every_rank
        elif case == "copy_without_all_reduce":
            coll._CopyToGroup.backward = staticmethod(lambda ctx, grad: (grad, None))
        try:
            loss, grads = _global_step(model, mesh, _tp_loss(model, mesh, q, d))
        finally:
            dense_mod.Dense.forward, coll._CopyToGroup.backward = real_forward, real_copy
        out[case] = {"loss": loss, "grads": grads}
    return out


def tp_remat(rank, world, workdir):
    """The TP model's split step with remat on: the replay repeats the
    forward's collectives, and the gradients are remat-off's bit for bit."""
    mesh = mesh_of(workdir)
    q, d = tp_batch()
    out = {}
    for remat in (False, True):
        model = tp_model(remat=remat)
        model.load_state_dict(_load(workdir, "tp_bert.pt"), strict=True)
        shard_module(model, mesh)
        out[remat] = _global_step(model, mesh, _tp_loss(model, mesh, q, d))
    return out


def tp_dropout(rank, world, workdir):
    """The TP model in training mode with attention dropout 0.1 (the plain
    sdpa): the split run's embeddings against the whole model's in the
    same process, the same generator seed."""
    from contrastors_tpu_torch.ops.dropout import step_generator

    mesh = mesh_of(workdir)
    state = _load(workdir, "tp_bert.pt")
    whole, split = tp_model(True, attn_pdrop=0.1), tp_model(True, attn_pdrop=0.1)
    whole.load_state_dict(state, strict=True)
    split.load_state_dict(state, strict=True)
    shard_module(split, mesh)
    q, _ = tp_batch()
    ids, mask = torch.from_numpy(q), torch.ones(q.shape, dtype=torch.long)
    with torch.no_grad():
        a = whole(ids, mask, generator=step_generator(torch.Generator().manual_seed(3)))["embedding"]
        b = split(ids, mask, generator=step_generator(torch.Generator().manual_seed(3)))["embedding"]
        c = whole(ids, mask, generator=step_generator(torch.Generator().manual_seed(4)))["embedding"]
    return {"whole": a, "split": b, "other_seed": c}


def _model_step(model, mesh, loss_of):
    plan = shard_module(model, mesh)
    loss, grads = _global_step(model, mesh, loss_of(model))
    return {"loss": loss, "grads": grads, "plan": sorted(plan)}


def tp_open_lm(rank, world, workdir):
    """open_lm with the rotary over heads: mean(h^2) and its gradients."""
    mesh = mesh_of(workdir)
    inp = _load(workdir, "tp_open_lm.pt")
    model = open_lm_model(inp["hf_cfg"])
    model.load_state_dict(inp["state"], strict=True)
    ids = torch.from_numpy(lm_ids())
    w = torch.from_numpy(proj(tuple(ids.shape) + (model.config.n_embd,)))
    return _model_step(model, mesh, lambda m: (m(ids)["last_hidden_state"] * w).mean())


def tp_vit(rank, world, workdir):
    """The EVA02 vision BiEncoder (norm_mlp, MAP head): mean((emb - w)^2)."""
    mesh = mesh_of(workdir)
    inp = _load(workdir, "tp_vit.pt")
    model = vit_model(inp["cfg"])
    model.load_state_dict(inp["state"], strict=True)
    px, w = torch.from_numpy(vit_pixels()), torch.from_numpy(vit_weights())
    return _model_step(model, mesh, lambda m: ((m(pixel_values=px)["embedding"] - w) ** 2).mean())


def _moe_case(workdir, name, cfg, seed, impls):
    """mean(h * w) over the global batch (a data rank's mean over its rows
    is its share) and its gradients, for each dispatch."""
    mesh = mesh_of(workdir)
    ids = rows(ep_ids(seed), mesh)
    w = torch.from_numpy(rows(proj((8, 8, cfg["n_embd"])), mesh))
    out = {}
    for impl in impls:
        model = moe_model(cfg, impl)
        model.load_state_dict(_load(workdir, f"{name}.pt"), strict=True)
        x, m = torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.long)
        out[impl] = _model_step(model, mesh, lambda mod: (mod(x, m)["last_hidden_state"] * w).mean())
        layer = model.layers[1].mlp
        out[impl]["local_w_up"] = tuple(layer.w_up.shape)
    return out


def ep_moe(rank, world, workdir):
    """_moe_cfg with the capacity and the dropless dispatch."""
    return _moe_case(workdir, "ep_moe", EP_CFG, 0, ("capacity", "dropless"))


def ep_tp_moe(rank, world, workdir):
    """test_tp_with_expert_axis_moe's config, both dispatches."""
    return _moe_case(workdir, "ep_tp_moe", EPTP_CFG, 2, ("dropless", "capacity"))


def round_trip(rank, world, workdir):
    """shard_state_dict then gather_state_dict of each family's whole state
    dict, and the split model's own gather, against the whole."""
    from contrastors_tpu_torch.parallel.sharding import shard_state_dict, split_plan

    mesh = mesh_of(workdir)
    inp = _load(workdir, "families.pt")
    out = {}
    for family, (build, arg) in {"nomic": (tp_model, None), "moe": (moe_model, EP_CFG),
                                 "vit": (vit_model, inp["vit_cfg"]), "neox": (neox_model, inp["neox_cfg"])}.items():
        torch.manual_seed(0)
        model = build() if arg is None else (build(arg, "dropless") if family == "moe" else build(arg))
        full = {k: v.clone() for k, v in model.state_dict().items()}
        plan = split_plan(model, mesh)
        parts = shard_state_dict(full, mesh, plan)
        back = gather_tensors(parts, plan, mesh)
        shard_module(model, mesh)
        own = gather_state_dict(model, mesh)
        out[family] = {"equal": all(torch.equal(back[k], full[k]) for k in full) and back.keys() == full.keys(),
                       "own_equal": all(torch.equal(own[k], full[k]) for k in full) and own.keys() == full.keys(),
                       "split": sorted(plan), "local": {k: tuple(parts[k].shape) for k in plan}}
    return out


# -- trainers ------------------------------------------------------------------
def _trainer_run(workdir, rank, case, raw):
    import torch_dist_trainer_cases as TC
    from contrastors_tpu_torch import train
    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

    out = raw["train_args"]["output_dir"]
    start = os.path.join(workdir, f"start_{case}.pt")
    state = torch.load(start) if os.path.exists(start) else None
    random.seed(rank)
    cls = TC.starting(TRAINER_REGISTRY[raw["model_args"]["model_type"]], state)
    trainer = train.run(Config.from_dict(raw), "fp32", "cpu", trainer_cls=cls)
    result = {"params": gather_state_dict(trainer.model, trainer.mesh),
              "local": {k: tuple(v.shape) for k, v in trainer.model.state_dict().items()},
              "replicas_agreed": trainer.init_replicas_agreed, "tracker": trainer.tracker is not None,
              "moe_impl": trainer.config.model_args.moe_impl}
    if rank == 0:
        result["metrics"] = TC.read_metrics(out)
        result["files"] = {d: sorted(os.listdir(os.path.join(out, d))) for d in os.listdir(out)
                           if d.startswith("step_")}
    return result


def trainer_raw(files, case, out_dir, parallel=None):
    """The pretrain recipe's tiny config (tests/torch_dist_trainer_cases.py's
    text cases, STEPS steps); `moe` adds 4 experts, top-2, MoE every second
    layer; parallel: the parallel_args."""
    import torch_dist_trainer_cases as TC

    raw = TC.raw_config(files, "text_std" if case == "ckpt" else "text_gc", out_dir)
    raw["train_args"]["num_train_steps"] = STEPS
    if case == "ckpt":
        raw["train_args"]["save_every"] = 2
        raw["model_args"].update(ema=True, ema_decay=0.9)
    if case == "moe":
        raw["model_args"].update(num_experts=4, moe_top_k=2, moe_every_n_layers=2)
        raw["train_args"]["router_aux_loss_coef"] = 0.01
    if parallel is not None:
        raw["parallel_args"] = dict(parallel, opt_state_shard_min_size=1024)
    return raw


def _files(workdir):
    with open(os.path.join(workdir, "files.json")) as f:
        return json.load(f)


def trainer_tp(rank, world, workdir):
    d, e, t = layout(workdir)
    raw = trainer_raw(_files(workdir), "text", os.path.join(workdir, "runs", "trainer_tp"),
                      dict(data=d, tensor=t, expert=e))
    return _trainer_run(workdir, rank, "text", raw)


def trainer_ckpt(rank, world, workdir):
    d, e, t = layout(workdir)
    raw = trainer_raw(_files(workdir), "ckpt", os.path.join(workdir, "runs", "trainer_ckpt"),
                      dict(data=d, tensor=t, expert=e))
    result = _trainer_run(workdir, rank, "text", raw)
    result["out"] = raw["train_args"]["output_dir"]
    return result


def trainer_moe(rank, world, workdir):
    d, e, t = layout(workdir)
    raw = trainer_raw(_files(workdir), "moe", os.path.join(workdir, "runs", "trainer_moe"),
                      dict(data=d, tensor=t, expert=e))
    raw["model_args"]["moe_impl"] = "auto"
    return _trainer_run(workdir, rank, "moe", raw)


def resume_raw(files, out_dir, layout_, shard, checkpoint=None):
    """The MoE recipe (capacity dispatch at factor 2: nothing drops) at
    layout_, saving at step 2, with or without shard_optimizer_state;
    resumed from `checkpoint` when given."""
    d, e, t = layout_
    raw = trainer_raw(files, "moe", out_dir, dict(data=d, tensor=t, expert=e, shard_optimizer_state=shard))
    raw["model_args"]["moe_impl"] = "capacity"
    raw["train_args"]["save_every"] = 2
    if checkpoint is not None:
        raw["train_args"]["checkpoint"] = checkpoint
    return raw


def same_state(a, b) -> bool:
    """Two whole optimizer states equal bit for bit."""
    return a["state"].keys() == b["state"].keys() and all(
        a["state"][i].keys() == b["state"][i].keys()
        and all(torch.equal(a["state"][i][k], b["state"][i][k]) for k in a["state"][i]) for i in a["state"])


def resume_run(rank, raw):
    """Train raw's run; with a checkpoint, first read back the optimizer
    state it resumed (whole) against the saved one. Returns the whole
    parameters, the optimizer's class, that reading and (rank 0) the
    metrics."""
    import torch_dist_trainer_cases as TC
    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.parallel.sharding import whole_optimizer_state
    from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

    random.seed(rank)
    trainer = TRAINER_REGISTRY["encoder"](Config.from_dict(raw), "fp32", "cpu")
    ckpt = raw["train_args"].get("checkpoint")
    restored = None
    if ckpt is not None:
        saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)["optimizer"]
        restored = same_state(saved, whole_optimizer_state(trainer.optimizer, trainer.mesh))
    trainer.train()
    out = raw["train_args"]["output_dir"]
    result = {"params": gather_state_dict(trainer.model, trainer.mesh), "optimizer": type(trainer.optimizer).__name__,
              "restored": restored, "out": out}
    if rank == 0:
        result["metrics"] = TC.read_metrics(out)
    return result


def trainer_resume_save(rank, world, workdir):
    """The uninterrupted run of resume_raw at this layout, ZeRO-2 moments
    with a data axis: the checkpoint that the resume cases read."""
    lay = layout(workdir)
    name = "resume_zero" if lay[0] > 1 else "resume_layout"
    return resume_run(rank, resume_raw(_files(workdir), os.path.join(workdir, "runs", name), lay, lay[0] > 1))


def trainer_resumed(rank, world, workdir):
    """A resume from <workdir>/resume_from.json's checkpoint at this
    layout, without shard_optimizer_state."""
    with open(os.path.join(workdir, "resume_from.json")) as f:
        ckpt = json.load(f)
    return resume_run(rank, resume_raw(_files(workdir), os.path.join(workdir, "runs", "resumed"), layout(workdir),
                                       False, ckpt))


def at(layouts, fn):
    """fn at the given layouts, None at the others."""
    def case(rank, world, workdir):
        return fn(rank, world, workdir) if layout(workdir) in layouts else None
    return case


TP, TP2, EP, EPTP = (2, 1, 2), (1, 1, 2), (2, 2, 1), (1, 2, 2)
# the resume cases' layouts (ROADMAP Queue 1 item 1): 1 x 1 x 2 resumed at
# 1 x 1 x 1 (the test process) and 1 x 2 x 1; 2 x 1 x 2 with ZeRO-2
# resumed at 2 x 1 x 1 without it
RESUME_EXPERT, RESUME_DATA = (1, 2, 1), (2, 1, 1)
CASES = {
    "tp_bert": at((TP, TP2), tp_bert),
    "tp_faults": at((TP2,), tp_faults),
    "tp_dropout": at((TP2,), tp_dropout),
    "tp_remat": at((TP2,), tp_remat),
    "tp_open_lm": at((TP2,), tp_open_lm),
    "tp_vit": at((TP2,), tp_vit),
    "trainer_tp": at((TP,), trainer_tp),
    "trainer_ckpt": at((TP2,), trainer_ckpt),
    "ep_moe": at((EP,), ep_moe),
    "ep_tp_moe": at((EPTP,), ep_tp_moe),
    "round_trip": at((EPTP,), round_trip),
    "trainer_moe": at((EPTP,), trainer_moe),
    "trainer_resume_save": at((TP, TP2), trainer_resume_save),
    "trainer_resumed": at((RESUME_EXPERT, RESUME_DATA), trainer_resumed),
}
