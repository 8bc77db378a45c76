"""Parameter sharding over the mesh: the tensor and expert splits of the
model, and optimizer-state sharding over the data axis (ZeRO-2 style).

Counterpart of `contrastors_tpu/parallel/sharding.py` (`tp_param_spec`,
`param_shardings`, `shard_optimizer_state`) and of
`contrastors_tpu/models/moe_interop.py:moe_param_sharding_rules`.

The split rule (`split_rule`) maps a parameter's name and shape to a
`Split`: the torch dim split over the tensor axis, if any, and whether dim
0 is split over the expert axis. It uses JAX's parent names. `Wqkv`, `Wq`,
`Wkv`, `fc1`, `fc11`, `fc12` are column splits (the output features: torch
dim 0 of a Dense weight [out, in], and the bias); `out_proj` and `fc2` are
row splits (the input features, torch dim 1; the bias stays whole and is
added once, after the all-reduce). MoE `w_up` / `w_gate` / `w_in` [E, D, F]
split F (dim 2) and `w_down` [E, F, D] splits F (dim 1) over the tensor
axis, and dim 0 over the expert axis. Everything else stays whole
(replicated), as in JAX, and so does a leaf whose dim does not divide, as
JAX's fallback keeps it, with the same result. One difference: the fused
`Wqkv` holds q | k | v (`layers/attention.py`), and a tensor rank takes its
heads of each, three slices (`Split.sections`), where JAX's GSPMD splits
the flat output dim and reshards. So an attention layer splits when its
heads divide (n_head and num_heads_kv by the tensor axis) and stays whole
otherwise, where JAX would split the flat dim whenever it divides.

`shard_module(model, mesh)` slices a whole, replicated model for this rank
in place, tells its layers their groups (a MoE layer also the data axis,
over which it routes: `layers/moe.py`) and each parameter the model
groups that hold it whole (`replica_groups`, over which the optimizer
averages its gradient: `parallel/collectives.py:average_replica_grads`); `shard_state_dict` slices a
whole state dict (a checkpoint, `convert.flax_to_torch`'s output) for this
rank and `gather_state_dict` is its exact inverse: the round trip is bit for
bit. A split parameter carries its `mesh_split` and its `split_groups` (the
groups over which it is split), which `utils/optim.py:global_norm` reads.

`ShardedAdamW` (reference: DeepSpeed stage 2, configs/deepspeed/
ds_config.json): a leaf with at least `min_size` elements and a leading dim
divisible by the data axis keeps its Adam moments on one rank per block of
rows: rank r of the data group owns rows [r * n / W, (r + 1) * n / W) of
its (local) leaf. Every rank still holds its whole local parameter and its
whole (all-reduced) gradient; the update of a sharded leaf runs on the
owner's rows only, and the updated rows of every sharded leaf are
all-gathered over the data group, one flat buffer per dtype. Elementwise
AdamW on a block of rows gives those rows' values of the whole-tensor
update, and the clip's global norm is taken over the whole gradients, so
the parameters equal the replicated run's exactly.

`whole_optimizer_state` is the optimizer's state dict with every moment
whole: a sharded leaf's rows gathered over the data group, then a split
parameter's parts over the groups that split it, as `gather_state_dict`
takes the model. `load_whole_optimizer_state` is its inverse at any
(expert, tensor) layout and with or without `shard_optimizer_state`: each
moment is cut to this rank's part of its parameter, then to its block of
rows. The state is keyed by the parameters' order, which is the same at
every layout (the whole model's `named_parameters`). The step counters and
every moment come back bit for bit, as JAX's orbax restores its train state
onto the current shardings (`contrastors_tpu/trainers/base.py:297-310`).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from contrastors_tpu_torch.parallel.collectives import average_replica_grads
from contrastors_tpu_torch.parallel.mesh import Mesh
from contrastors_tpu_torch.utils.optim import AdamW, global_norm, split_groups_of

COLUMN = ("Wqkv", "Wq", "Wkv", "fc1", "fc11", "fc12")
ROW = ("out_proj", "fc2")
ATTENTION = ("Wqkv", "Wq", "Wkv", "out_proj")
EXPERT_UP = ("w_up", "w_gate", "w_in")


@dataclass(frozen=True)
class Split:
    """dim: the torch dim split over the tensor axis (None: not split
    there). sections: the whole tensor's sizes along dim of the blocks that
    split on their own (q | k | v of a fused projection); () for one block.
    expert: dim 0 split over the expert axis."""

    dim: Optional[int] = None
    sections: Tuple[int, ...] = ()
    expert: bool = False


def split_rule(name: str, shape: Sequence[int], tensor: int, expert: int = 1,
               heads: Optional[Tuple[int, int, int]] = None) -> Optional[Split]:
    """The Split of parameter `name` (a state-dict key) of `shape` on a
    mesh of `tensor` x `expert`, or None when it stays whole. heads: (H,
    Hkv, D) of the attention layer that owns `name` (its Wqkv, Wq, Wkv and
    out_proj split only by whole heads)."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf in EXPERT_UP + ("w_down",) and len(shape) == 3:
        f = 1 if leaf == "w_down" else 2
        dim = f if tensor > 1 and shape[f] % tensor == 0 else None
        ex = expert > 1 and shape[0] % expert == 0
        return Split(dim=dim, expert=ex) if dim is not None or ex else None
    if tensor == 1 or leaf not in ("weight", "bias") or parent not in COLUMN + ROW:
        return None
    sections: Tuple[int, ...] = ()
    if parent in ATTENTION:
        if heads is None:
            return None
        H, Hkv, D = heads
        if H % tensor or Hkv % tensor:
            return None
        sections = {"Wqkv": (H * D, Hkv * D, Hkv * D), "Wkv": (Hkv * D, Hkv * D)}.get(parent, ())
    if parent in COLUMN:
        return Split(dim=0, sections=sections) if shape[0] % tensor == 0 else None
    if leaf == "weight" and shape[1] % tensor == 0:
        return Split(dim=1)
    return None


def _heads_of(module: nn.Module) -> Optional[Tuple[int, int, int]]:
    from contrastors_tpu_torch.layers.attention import AttentionPooling, MultiHeadAttention

    if isinstance(module, (MultiHeadAttention, AttentionPooling)):
        cfg = module.config
        return cfg.n_head, cfg.num_heads_kv, cfg.head_dim
    return None


def split_plan(model: nn.Module, mesh: Mesh) -> Dict[str, Split]:
    """{parameter name: Split} of every parameter of the whole model that
    the mesh splits."""
    if mesh.tensor == 1 and mesh.expert == 1:
        return {}
    heads = {name: h for name, m in model.named_modules() if (h := _heads_of(m)) is not None}
    plan = {}
    for name, p in model.named_parameters():
        owner = name.rsplit(".", 2)[0] if name.count(".") >= 2 else ""
        split = split_rule(name, p.shape, mesh.tensor, mesh.expert, heads.get(owner))
        if split is not None:
            plan[name] = split
    return plan


def split_groups(split: Split, mesh: Mesh) -> Tuple:
    """The process groups over which a Split parameter is split."""
    return tuple(g for g, on in ((mesh.tensor_group, split.dim is not None), (mesh.expert_group, split.expert))
                 if on and g is not None)


def local_part(t: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the whole tensor t (a copy)."""
    if split.expert:
        t = t.chunk(mesh.expert, dim=0)[mesh.expert_rank]
    if split.dim is not None:
        d, T, r = split.dim, mesh.tensor, mesh.tensor_rank
        t = torch.cat([s.chunk(T, dim=d)[r] for s in t.split(list(split.sections or (t.shape[d],)), dim=d)], dim=d)
    return t.clone()


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


@torch.no_grad()
def whole_tensor(t: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which t is this rank's part (`local_part`'s
    inverse), the same on every rank; a collective over the groups that
    split it."""
    t = t.detach()
    if split.dim is not None and mesh.tensor_group is not None:
        d, T = split.dim, mesh.tensor
        parts = _all_gather(t, mesh.tensor_group)
        local = [s // T for s in (split.sections or (t.shape[d] * T,))]
        pieces = [p.split(local, dim=d) for p in parts]
        t = torch.cat([pieces[r][i] for i in range(len(local)) for r in range(T)], dim=d)
    if split.expert and mesh.expert_group is not None:
        t = torch.cat(_all_gather(t, mesh.expert_group), dim=0)
    return t


def param_splits(module: nn.Module) -> Dict[str, Split]:
    """{name: Split} of the split parameters of a sharded module."""
    return {n: p.mesh_split for n, p in module.named_parameters() if getattr(p, "mesh_split", None) is not None}


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Mesh, splits: Dict[str, Split]) -> Dict[str, torch.Tensor]:
    """This rank's state dict of a whole one: the parts of the keys in
    `splits` (`split_plan` of the whole model, or `param_splits` of a
    sharded one), the other keys as they are."""
    return {k: local_part(v, splits[k], mesh) if k in splits else v for k, v in full.items()}


@torch.no_grad()
def gather_tensors(tensors: Dict[str, torch.Tensor], splits: Dict[str, Split], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole tensors of this rank's parts (every rank must call it, with
    the same keys in the same order)."""
    return {k: whole_tensor(v, splits[k], mesh) if k in splits else v.detach() for k, v in tensors.items()}


def gather_state_dict(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The state dict of the whole module, with the keys and shapes of a
    one-rank run (`shard_state_dict`'s inverse, bit for bit)."""
    return gather_tensors(module.state_dict(), param_splits(module), mesh)


@torch.no_grad()
def shard_module(model: nn.Module, mesh: Mesh) -> Dict[str, Split]:
    """Slice the whole, replicated model for this rank in place: every
    parameter of `split_plan` becomes this rank's part (a new Parameter,
    so build the optimizer after), and the layers that own them learn
    their groups (a Dense its column or row split, an attention layer its
    local heads, a gated MLP its split hidden width, a MoE layer its local
    experts and hidden columns). Returns the plan; {} leaves the model as
    it is."""
    from contrastors_tpu_torch.layers.attention import AttentionPooling, MultiHeadAttention
    from contrastors_tpu_torch.layers.dense import Dense
    from contrastors_tpu_torch.layers.mlp import GatedMLP
    from contrastors_tpu_torch.layers.moe import MoEMLP, route_over_data

    route_over_data(model, mesh.data_part)
    plan = split_plan(model, mesh)
    for prefix, m in model.named_modules():
        pre = prefix + "." if prefix else ""
        if isinstance(m, Dense) and pre + "weight" in plan:
            m.split = "column" if plan[pre + "weight"].dim == 0 else "row"
            m.group = mesh.tensor_group
        elif isinstance(m, (MultiHeadAttention, AttentionPooling, GatedMLP)):
            if pre + "out_proj.weight" in plan or pre + "fc2.weight" in plan:
                m.tp = mesh.tensor_part
        elif isinstance(m, MoEMLP) and pre + "w_down" in plan:
            split = plan[pre + "w_down"]
            m.tp = mesh.tensor_part if split.dim is not None else None
            m.ep = mesh.expert_part if split.expert else None
    for name, split in plan.items():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        module = model.get_submodule(owner)
        old = module._parameters[leaf]
        new = nn.Parameter(local_part(old.detach(), split, mesh), requires_grad=old.requires_grad)
        new.mesh_split, new.split_groups = split, split_groups(split, mesh)
        module._parameters[leaf] = new
    for p in model.parameters():  # the model axes that hold each parameter whole
        split = getattr(p, "mesh_split", None) or Split()
        p.replica_groups = tuple(g for g, size, on in ((mesh.tensor_group, mesh.tensor, split.dim is None),
                                                       (mesh.expert_group, mesh.expert, not split.expert))
                                 if size > 1 and on)
    return plan


def shardable(p: torch.Tensor, data: int, min_size: int) -> bool:
    return p.ndim >= 1 and p.numel() >= min_size and p.shape[0] % data == 0


class ShardedAdamW(AdamW):
    """`AdamW` (the global-norm clip, then torch's AdamW) whose moments of
    large leaves live on their owner rank. `full_params` are the model's
    parameters in the replicated optimizer's order; `sharded` says which of
    them the optimizer sees as this rank's block of rows."""

    def __init__(self, optimizer: AdamW, mesh: Mesh, min_size: int = 2**16):
        self.mesh = mesh
        self.full_params: List[torch.Tensor] = []
        self.sharded: List[bool] = []
        self._views: List[torch.Tensor] = []
        groups = []
        for g in optimizer.param_groups:
            params = []
            for p in g["params"]:
                split = shardable(p, mesh.data, min_size)
                view = p.detach().chunk(mesh.data)[mesh.rank] if split else p
                self.full_params.append(p)
                self.sharded.append(split)
                self._views.append(view)
                params.append(view)
            groups.append({**{k: v for k, v in g.items() if k != "params"}, "params": params})
        defaults = optimizer.defaults
        super().__init__(groups, max_grad_norm=optimizer.max_grad_norm, lr=defaults["lr"],
                         betas=defaults["betas"], eps=defaults["eps"], weight_decay=defaults["weight_decay"])

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none)
        for p in self.full_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for p in self.full_params if p.grad is not None]
        average_replica_grads(params)
        grads = [p.grad for p in params]
        self.grad_norm = global_norm(grads, split_groups_of(params))
        if self.max_grad_norm is not None and self.max_grad_norm > 0 and grads:
            torch._foreach_mul_(grads, (self.max_grad_norm / self.grad_norm).clamp(max=1.0))
        for p, view, split in zip(self.full_params, self._views, self.sharded):
            if split:
                view.grad = None if p.grad is None else p.grad.chunk(self.mesh.data)[self.mesh.rank]
        out = torch.optim.AdamW.step(self, closure)
        self.gather_updated_rows()
        return out

    @torch.no_grad()
    def gather_updated_rows(self):
        """Every data rank's updated rows of the sharded leaves into every
        data rank's parameters: one all-gather over the data group of a flat
        buffer per dtype (every rank's buffer holds the same leaves, as
        every rank holds the same gradients)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p, split in zip(self.full_params, self.sharded):
            if split and p.grad is not None:
                by_dtype.setdefault(p.dtype, []).append(p)
        data, rank = self.mesh.data, self.mesh.rank
        for params in by_dtype.values():
            own = torch.cat([p.detach().chunk(data)[rank].reshape(-1) for p in params])
            parts = [torch.empty_like(own) for _ in range(data)]
            dist.all_gather(parts, own, group=self.mesh.group)
            sizes = [p.numel() // data for p in params]
            for r, flat in enumerate(parts):
                if r != rank:
                    rows = [p.detach().chunk(data)[r] for p in params]
                    torch._foreach_copy_(rows, [v.view_as(t) for v, t in zip(flat.split(sizes), rows)])


def _moment(v) -> bool:
    """A per-element state tensor (Adam's moments; not the 0-d step)."""
    return torch.is_tensor(v) and v.ndim > 0


@torch.no_grad()
def whole_optimizer_state(optimizer: torch.optim.Optimizer, mesh: Mesh) -> Dict:
    """The optimizer's state dict with whole moments (module docstring): a
    collective over the data and model groups, so every rank calls it; every
    rank gets the same."""
    sd = optimizer.state_dict()
    params = optimizer_params(optimizer)
    sharded = getattr(optimizer, "sharded", [False] * len(params))
    state = {}
    for i, st in sorted(sd["state"].items()):
        split = getattr(params[i], "mesh_split", None)
        out = {}
        for k, v in st.items():
            if _moment(v):
                if sharded[i]:
                    v = torch.cat(_all_gather(v, mesh.group))
                if split is not None:
                    v = whole_tensor(v, split, mesh)
            out[k] = v
        state[i] = out
    return {"state": state, "param_groups": sd["param_groups"]}


@torch.no_grad()
def load_whole_optimizer_state(optimizer: torch.optim.Optimizer, whole: Dict, mesh: Mesh) -> None:
    """Load `whole_optimizer_state`'s output into this rank's optimizer, at
    this rank's part of each parameter and its block of rows."""
    params = optimizer_params(optimizer)
    sharded = getattr(optimizer, "sharded", [False] * len(params))
    state = {}
    for i, st in whole["state"].items():
        split = getattr(params[i], "mesh_split", None)
        out = {}
        for k, v in st.items():
            if _moment(v):
                if split is not None:
                    v = local_part(v, split, mesh)
                if sharded[i]:
                    v = v.chunk(mesh.data)[mesh.rank].clone()
            out[k] = v
        state[i] = out
    optimizer.load_state_dict({"state": state, "param_groups": whole["param_groups"]})


def shard_optimizer_state(optimizer: AdamW, mesh: Mesh, min_size: int = 2**16) -> AdamW:
    """The optimizer with its large leaves' moments sharded over the data
    axis; the optimizer itself for one rank. Call before the first step
    (the moments start empty)."""
    if mesh.data <= 1:
        return optimizer
    return ShardedAdamW(optimizer, mesh, min_size)


def optimizer_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The (local) parameters an optimizer updates (a sharded one's
    `full_params`)."""
    full = getattr(optimizer, "full_params", None)
    if full is not None:
        return list(full)
    return [p for g in optimizer.param_groups for p in g["params"]]
