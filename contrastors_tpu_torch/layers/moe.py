"""Mixture-of-experts MLP, counterpart of `contrastors_tpu/layers/moe.py:MoEMLP`.

Routing: fp32 router logits x @ router [D, E]; softmax over the unmasked
logits. The layer returns the masked logits (-1e9 on padding) for the
router load-balance loss. Three dispatches read the same expert parameters:

  - token choice, moe_impl="dropless" (megablocks' dMoE): top-k, optional
    renormalisation, weight 0 for padding tokens (which still occupy rows).
    The N*k assignments are laid out expert-sorted with 128-row aligned
    groups (`ops.grouped_matmul.aligned_group_layout`), gathered from the
    tokens through an appended zero row (the padding rows' sentinel; its
    gradient is dropped), run through three grouped matmuls (up and gate,
    then down after the gated activation), gathered back by `dest` and
    combined by weight. Nothing is dropped.
  - token choice, moe_impl="capacity" (Switch / Mesh-TF): each expert has
    C = min(max(capacity_factor * N * k / E, k), N) slots, taken by its
    assignments in token order (a padding token's assignment takes its
    place in that order and is then dropped); an [E, C] token-index table
    (sentinel N, the appended zero row) and an [E, C] weight table gather
    the tokens, `torch.bmm` runs the expert MLPs, and a scatter-add
    (`index_add`) combines them. Assignments past C are dropped.
  - expert_choice_router=True (Zhou et al. 2022): each expert takes its
    top C = min(max(capacity_factor * N * k / E, 1), N) tokens by score
    (padding scores 0, ties to the lower index, as JAX's top_k), a picked
    padding token gets weight 0; the same bmm and scatter-add.
The capacity and expert-choice dispatches are plain PyTorch: JAX runs them
as einsums and gathers outside any Pallas kernel, so they launch no gmm.

`groups` splits the N tokens into that many equal blocks of whole rows
that route on their own, each with its own C, as that many separate calls
would: grad cache's pass 1 embeds several chunks per forward
(`embed_parallel`), where JAX vmaps the encoder over them. Dropless routing
is per token, so groups do not change it.

The data axis (`dp`, set by `parallel/sharding.py:shard_module` and by the
`Encoder`'s mesh form): JAX's standard step and its mesh `Encoder` run
under GSPMD, where the layer sees the global batch, so its C and its
queues are those of every data rank's tokens together, in rank order (data
rank 0's rows first, as `all_gather_rows` orders them). With `dp` set the
capacity and expert-choice dispatches route over that global batch:
  - token choice: C from the global N (every data rank holds N tokens, one
    padded length, as JAX's global batch has), and an assignment's place in
    its expert's queue is its place among this rank's assignments plus the
    counts of the lower data ranks' assignments to that expert (one
    all-gather of E integers over the data group);
  - expert choice: the scores are gathered over the data group (detached:
    selection has no gradient), each expert takes its top C of all of
    them (equal scores to the lower global token index), and each rank
    combines the picks among its own tokens, with weights read from its own
    probabilities, so the gradient stays local.
The tables are this rank's columns only ([E, min(C, N)]). The expert peers
of a data rank hold the same tokens, so the gather runs over the data group
alone. Grad cache routes each chunk on its own, as JAX's shard_map form
does, and in its GSPMD form a global chunk of chunk_size rows is one rank's
chunk (`grad_cache.py`): it runs its passes inside `local_routing()`.

Optional shared experts (Dense layers on every token) blend in by
assignment count, then the output bias. Nothing is read back to the host.

The expert and tensor axes (`parallel/sharding.py:shard_module`): the
router and routing are replicated. Every peer of an expert group holds the
same tokens and computes the same top-k and [E, C] tables, so the experts
need no all-to-all: a rank runs its E/e local experts (`ep`), with F/t of
their hidden width under the tensor axis (`tp`), and the partial outputs
are summed by `reduce_from_group` over both groups. The tokens and the
combine weights enter the local experts through `copy_to_group`, so that
the gradients of x and of the router are whole. The capacity and expert
choice dispatches take the table rows of the local experts; the dropless
one lays out only the local experts' assignments (the others go to a last
group past the local ones, whose blocks are inactive: gmm writes 0 there)
and runs gmm / tgmm on [E/e, ...] weights with the local group sizes. The
output bias is added once, after the sum; the shared experts are
replicated. Every collective is called on every peer in the same order,
also by a rank whose local experts took no rows.

Parameters keep the JAX names and shapes so that `convert.flax_to_torch`
maps them one to one: `router` [D, E], `w_up`/`w_gate` [E, D, F] and
`w_down` [E, F, D] (`w_in` for an ungated activation), `bias` [D], and the
`shared_*` Dense layers. They are stored in fp32 and cast to the compute
dtype where used, as `layers/dense.py` does.
"""

import contextlib
from typing import Any, Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.activations import ACT2FN, is_gated
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.ops.grouped_matmul import aligned_group_layout, block_experts, gmm
from contrastors_tpu_torch.parallel.collectives import all_gather_rows, copy_to_group, reduce_from_group

# > 0 inside `local_routing()`: a process-wide count, not a thread-local
# one, because the autograd engine replays activation checkpoints on its
# own threads
_LOCAL_ROUTING = [0]


@contextlib.contextmanager
def local_routing():
    """Every MoE layer routes over the tokens of its own call, whatever its
    `dp` (grad cache's chunks)."""
    _LOCAL_ROUTING[0] += 1
    try:
        yield
    finally:
        _LOCAL_ROUTING[0] -= 1


def route_over_data(module: nn.Module, part) -> None:
    """Set the data axis (an `AxisPart`, or None) over which every MoE
    layer of module routes."""
    for m in module.modules():
        if isinstance(m, MoEMLP):
            m.dp = part


class MoEMLP(nn.Module):
    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        if cfg.moe_impl not in ("dropless", "capacity"):
            # "auto" is resolved by the trainer (dropless with no expert axis)
            raise ValueError(f"moe_impl={cfg.moe_impl!r}: expected 'dropless' or 'capacity'")
        self.config, self.dtype = cfg, dtype
        D, std = cfg.n_embd, cfg.initializer_range
        self.num_shared = cfg.num_shared_experts
        self.num_routed = cfg.num_experts - self.num_shared
        self.top_k = cfg.moe_top_k - self.num_shared
        self.block_m = int(cfg.moe_block_m)
        self.capacity_factor = float(cfg.moe_capacity_factor)
        self.gated = is_gated(cfg.activation_function)
        self.act = ACT2FN[cfg.activation_function]
        F_hid = cfg.n_inner // cfg.ffn_div
        E = self.num_routed

        def param(*shape):
            return nn.Parameter(torch.randn(shape, device=device) * std)

        self.router = param(D, E)
        if self.gated:
            self.w_up, self.w_gate = param(E, D, F_hid), param(E, D, F_hid)
        else:
            self.w_in = param(E, D, F_hid)
        self.w_down = param(E, F_hid, D)
        if self.num_shared > 0:
            hid = F_hid * self.num_shared
            kw = dict(bias=False, dtype=dtype, device=device)
            self.shared_up = Dense(D, hid, **kw)
            self.shared_gate = Dense(D, hid, **kw)
            self.shared_down = Dense(hid, D, **kw)
        self.bias = nn.Parameter(torch.zeros(D, device=device))
        # the tensor and expert axes (AxisParts), when the experts are split
        self.tp: Optional[Any] = None
        self.ep: Optional[Any] = None
        # the data axis over which routing runs (module docstring)
        self.dp: Optional[Any] = None

    @property
    def _groups(self):
        """The groups over which the local experts' outputs are partial."""
        return tuple(a.group for a in (self.tp, self.ep) if a is not None)

    def _local_experts(self):
        """(first local expert, number of local experts)."""
        if self.ep is None:
            return 0, self.num_routed
        n = self.num_routed // self.ep.size
        return self.ep.rank * n, n

    def route(self, probs, valid):
        """Token-choice routing of the router probabilities [N, E]: (top-k
        weights, top-k experts), the weights renormalised when the config
        asks and 0 for padding tokens (valid [N, 1] False)."""
        top_w, top_e = torch.topk(probs, self.top_k, dim=-1)
        if self.config.moe_normalize_expert_weights:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        return top_w * valid.to(top_w.dtype), top_e

    def _experts(self, xs, group_sizes):
        """The expert MLPs over the aligned rows [P, D]; the three gmm share
        one block -> expert table."""
        dt, bm = self.dtype, self.block_m
        blocks = block_experts(group_sizes, xs.shape[0] // bm, bm)
        if self.gated:
            h = gmm(xs, self.w_up.to(dt), group_sizes, bm, blocks)
            h = h * self.act(gmm(xs, self.w_gate.to(dt), group_sizes, bm, blocks))
        else:
            h = self.act(gmm(xs, self.w_in.to(dt), group_sizes, bm, blocks))
        return gmm(h, self.w_down.to(dt), group_sizes, bm, blocks)

    def _expert_bmm(self, expert_in):
        """The expert MLPs over a slot table's tokens [E, C, D]."""
        dt = self.dtype
        if self.gated:
            h = torch.bmm(expert_in, self.w_up.to(dt)) * self.act(torch.bmm(expert_in, self.w_gate.to(dt)))
        else:
            h = self.act(torch.bmm(expert_in, self.w_in.to(dt)))
        return torch.bmm(h, self.w_down.to(dt))

    def _combine(self, x_rows, idx, weights, n_out):
        """Scatter-add of the experts' weighted outputs over the tokens of
        the [E, C] table idx into [n_out, D]."""
        D = x_rows.shape[-1]
        expert_out = self._expert_bmm(x_rows[idx])
        contrib = (expert_out * weights[..., None].to(expert_out.dtype)).reshape(-1, D)
        return contrib.new_zeros((n_out, D)).index_add(0, idx.reshape(-1), contrib)

    def _dropless(self, x, top_w, top_e):
        N, D = x.shape
        k = self.top_k
        lo, n_local = self._local_experts()
        flat_e = top_e.reshape(-1)
        token_of = torch.arange(N, device=x.device).repeat_interleave(k)
        if self.ep is not None:
            # other ranks' assignments: a last group past the local ones,
            # gathering the zero row, in blocks that gmm leaves inactive
            mine = (flat_e >= lo) & (flat_e < lo + n_local)
            flat_e = torch.where(mine, flat_e - lo, n_local)
            token_of = torch.where(mine, token_of, N)
        dest, group_sizes, P, src = aligned_group_layout(
            flat_e, n_local + (self.ep is not None), self.block_m, src_of=token_of, sentinel=N
        )
        x_pad = torch.cat([x.to(self.dtype), x.new_zeros((1, D), dtype=self.dtype)])
        y = self._experts(x_pad[src], group_sizes[:n_local])
        y_assign = y[dest].reshape(N, k, D)
        return (y_assign * top_w[..., None].to(y_assign.dtype)).sum(dim=1)

    def _capacity_slots(self, top_e, valid, groups, dp):
        """(width, col, ok) of token choice with C slots an expert in each
        group of n tokens, or in the global batch over dp: col [G, n*k] is
        each assignment's column in this rank's [E, G * width] table (its
        place in its expert's queue, less the lower data ranks' count;
        width = min(C, n)), ok whether it is a valid token's and takes a
        slot."""
        N = valid.shape[0]
        E, k, G = self.num_routed, self.top_k, groups
        n = N // G
        experts = torch.arange(E, device=valid.device)
        onehot = (top_e.reshape(G, n * k)[..., None] == experts).long()  # [G, n*k, E]
        col = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(dim=-1)
        pos, n_route = col, n
        if dp is not None:
            counts = all_gather_rows(onehot.sum(dim=1), dp.group)  # [W, E], rank order
            below = counts[:dp.rank].sum(dim=0)
            pos, n_route = col + (onehot * below).sum(dim=-1), n * dp.size
        C = min(int(max(self.capacity_factor * n_route * k / max(E, 1), k)), n_route)
        ok = (pos < C) & valid.reshape(G, n, 1).expand(G, n, k).reshape(G, n * k)
        return min(C, n), col, ok

    def _capacity(self, x, top_w, top_e, valid, groups, dp):
        """Token choice through the [E, C] tables; the table's columns are
        the groups' slots side by side."""
        N, D = x.shape
        E, k, G = self.num_routed, self.top_k, groups
        width, col, ok = self._capacity_slots(top_e, valid, groups, dp)
        offset = (torch.arange(G, device=x.device) * width)[:, None]
        col = torch.where(ok, col + offset, G * width).reshape(-1)  # G*width: the dropped column
        ok = ok.reshape(-1)
        flat_e = top_e.reshape(-1)
        token_of = torch.arange(N, device=x.device).repeat_interleave(k)
        idx = torch.full((E, G * width + 1), N, dtype=torch.long, device=x.device)
        idx = idx.index_put((flat_e, col), torch.where(ok, token_of, N))[:, :G * width]
        w = torch.zeros((E, G * width + 1), dtype=torch.float32, device=x.device)
        w = w.index_put((flat_e, col), torch.where(ok, top_w.reshape(-1).float(), 0.0))[:, :G * width]
        x_pad = torch.cat([x.to(self.dtype), x.new_zeros((1, D), dtype=self.dtype)])
        lo, n_local = self._local_experts()
        return self._combine(x_pad, idx[lo:lo + n_local], w[lo:lo + n_local], N + 1)[:N]

    def _expert_choice(self, x, probs, valid, groups, dp):
        """Each expert's top C tokens of each group of n, or of the global
        batch over dp, by score."""
        N, D = x.shape
        E, k, G = self.num_routed, self.top_k, groups
        n = N // G
        scores = torch.where(valid, probs, 0.0)
        if dp is not None:
            return self._expert_choice_global(x, scores, valid, dp)
        C = min(int(max(self.capacity_factor * n * k / max(E, 1), 1)), n)
        scores = scores.reshape(G, n, E).transpose(1, 2)  # [G, E, n]
        # stable: equal scores go to the lower token index, as JAX's top_k
        g, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        g, idx = g[..., :C], idx[..., :C] + (torch.arange(G, device=x.device) * n)[:, None, None]
        idx = idx.transpose(0, 1).reshape(E, G * C)
        g = g.transpose(0, 1).reshape(E, G * C) * valid.reshape(-1)[idx].to(g.dtype)  # picked pads: 0
        lo, n_local = self._local_experts()
        return self._combine(x.to(self.dtype), idx[lo:lo + n_local], g[lo:lo + n_local], N)

    def _expert_choice_global(self, x, scores, valid, dp):
        """Expert choice over every data rank's tokens (module docstring):
        this rank's picks in an [E, min(C, N)] table (sentinel N, weight
        0), weighted by its own scores."""
        N, D = x.shape
        E, k = self.num_routed, self.top_k
        n_route = N * dp.size
        C = min(int(max(self.capacity_factor * n_route * k / max(E, 1), 1)), n_route)
        every = all_gather_rows(scores.detach(), dp.group)  # [W*N, E], rank order
        _, picked = torch.sort(every.t(), dim=-1, descending=True, stable=True)
        picked = picked[:, :C] - dp.rank * N  # [E, C], this rank's tokens in [0, N)
        mine = (picked >= 0) & (picked < N)
        width = min(C, N)
        col = torch.where(mine, mine.long().cumsum(dim=-1) - 1, width)
        experts = torch.arange(E, device=x.device)[:, None].expand(E, C)
        idx = torch.full((E, width + 1), N, dtype=torch.long, device=x.device)
        idx = idx.index_put((experts, col), torch.where(mine, picked, N))[:, :width]
        pad = lambda t: torch.cat([t, t.new_zeros((1,) + t.shape[1:])])  # noqa: E731
        g = pad(scores)[idx, experts[:, :width]] * pad(valid.reshape(-1, 1))[idx, 0].to(scores.dtype)
        x_pad = torch.cat([x.to(self.dtype), x.new_zeros((1, D), dtype=self.dtype)])
        lo, n_local = self._local_experts()
        return self._combine(x_pad, idx[lo:lo + n_local], g[lo:lo + n_local], N + 1)[:N]

    def forward(self, hidden_states: torch.Tensor, attention_mask=None, groups: int = 1):
        """Returns (output [B, S, D] in hidden_states.dtype, masked router
        logits [B*S, E] fp32). groups divides B (module docstring)."""
        B, S, D = hidden_states.shape
        N = B * S
        if B % groups:
            raise ValueError(f"{B} rows do not split into {groups} routing groups")
        x = hidden_states.reshape(N, D)

        logits = x.float() @ self.router  # [N, E]
        if attention_mask is not None:
            valid = attention_mask.reshape(N, 1).bool()
            logits_masked = logits.masked_fill(~valid, -1e9)
        else:
            valid = torch.ones((N, 1), dtype=torch.bool, device=x.device)
            logits_masked = logits
        probs = torch.softmax(logits, dim=-1)
        split = self._groups
        # routing over the data axis: the standard step's and the mesh
        # Encoder's global batch; never for grad cache's chunks
        dp = self.dp if groups == 1 and not _LOCAL_ROUTING[0] else None
        # the local experts' region: replicated tensors enter by copy_to_group
        # and its partial outputs leave by reduce_from_group (identities
        # without a split)
        xe = copy_to_group(x, split)
        if self.config.expert_choice_router:
            out = self._expert_choice(xe, copy_to_group(probs, split), valid, groups, dp)
        else:
            top_w, top_e = self.route(probs, valid)  # [N, k]
            top_w = copy_to_group(top_w, split)
            if self.config.moe_impl == "capacity":
                out = self._capacity(xe, top_w, top_e, valid, groups, dp)
            else:
                out = self._dropless(xe, top_w, top_e)
        out = reduce_from_group(out, split)

        if self.num_shared > 0:
            shared = self.shared_down(self.shared_up(x) * self.act(self.shared_gate(x)))
            # megablocks shared_expert_weighted_sum: blend by assignment counts
            frac = self.num_shared / self.config.moe_top_k
            out = shared * frac + out * (1.0 - frac)
        out = out + self.bias.to(out.dtype)
        return out.reshape(B, S, D).to(hidden_states.dtype), logits_masked
