"""The trainer loop and the standard train step, in PyTorch.

Counterpart of `contrastors_tpu/trainers/base.py`:

`make_standard_train_step` (`:208-267`): one forward and backward per
micro-batch, `loss_fn(batch, generator)` receiving the step's generator as JAX's
`loss_fn(params, batch, rng)` receives its rng; with
gradient_accumulation_steps = N the gradients of N micro-batches are summed
(in the fp32 parameters' .grad, in micro-batch order, as JAX adds its
gradient trees) and the optimizer applies their mean on the N-th.
`grad_norm` is the global norm of that mean before the clip, reported on the
update's micro-step only, as in JAX.

The mesh (`parallel_args` data x expert x tensor, JAX's mesh at
`:55-135`; `parallel/mesh.py`): one process per GPU under `torchrun`, each
rank on its own card (`utils/dist.py:maybe_initialize_distributed` sets
it). The data axis: each data rank holds its own rows of every global
batch, and its expert and tensor peers hold the same rows. The rank's loss
is its share of the global one (the shares add up over the data ranks to
JAX's loss on the global batch), its gradients are summed over the data
group once per applied update, after the last micro-step, in one
all-reduce (`parallel/collectives.py`), so the clip and `grad_norm` see
the global gradient, and the step's metrics are reduced over the data
group on the device ("loss" and "router_aux" summed, the rest averaged);
the step generator folds in the data rank only, so expert and tensor peers
draw the same noise. The tensor and expert axes split the model
(`parallel/sharding.py`): the whole model is built, broadcast from global
rank 0 over the world and its checksums compared, then sliced for this
rank in place (`shard_module`): Megatron's column and row splits over the
tensor group, the local experts over the expert group. Nothing is summed
over those groups in the step (their peers hold the same rows); the
Megatron functions inside the layers make each rank's gradients of its
shards and of the replicated parameters whole, and `grad_norm` counts each
parameter once (`utils/optim.py:global_norm`). With
`shard_optimizer_state` the Adam moments of large leaves live on their
owner rank of the data group. Global rank 0 alone writes the tracker, the
model, the optimizer state, the scheduler and step.txt; the model, the
Adam moments and the EMA in state.pt are the whole tensors (gathered:
`parallel/sharding.py:whole_optimizer_state`), with the keys of a one-rank
run, so export, eval and a resume at any expert and tensor layout, with or
without `shard_optimizer_state`, read them, as JAX's orbax restores the
train state onto the current shardings. Each data rank's (expert, tensor) =
(0, 0) peer writes its data cursor, so a resume at another data axis
raises, naming both layouts. A load waits for the writes in flight and for
every rank. Eval
metrics are averaged over the ranks (`process_allmean`).

`BaseTrainer` (`:53-460`) owns a run: seeding, tokenizer, data, model,
AdamW with its learning-rate schedule, EMA weights, checkpoints, logging,
in-train eval and the loop. What differs from JAX, and why:
  - The step's randomness is one draw from the trainer's CPU
    `torch.Generator` per step (`make_train_step`'s steps take it, and
    `make_standard_train_step` hands `loss_fn` the step's generator,
    `ops/dropout.py:step_generator`), where JAX splits its key; no draw
    touches the device.
  - A batch whose meta carries "lang" (the multilingual MLM data) adds its
    loss to that language's running losses, kept on the device and logged
    as `loss/<lang>` (their mean since the last log) in the log step's one
    stacked copy, as JAX does.
  - A checkpoint is `torch.save` of the modules, the optimizer, the
    scheduler, the generator's state and the EMA, with the data cursor,
    step.txt and trunk_config.json beside it. With async_checkpointing the
    tensors are copied to the host at once and a background thread writes
    the file; that write is waited on before the next save, before any
    load of the same path, and at the end of `train()`, as JAX waits on its
    orbax writer, and an error in it is raised there.
  - The loop syncs with the device only on log, save and eval steps: the
    prefetch thread collates and pins the batch, the loop issues its copy
    to the device without waiting, and metrics stay on the device until
    the tracker fetches them.
  - moe_impl "auto" resolves as JAX's does: "capacity" when the expert
    axis is above 1, else "dropless".
  - The step is built after the first batch's `transform_host_batch`, as
    JAX builds it (`:321-325,368-376`), so that `packed_auto` can turn
    packing off before the step reads the flag.
"""

import os
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from contrastors_tpu_torch._device import DTYPES, resolve_device
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.ops.dropout import step_generator
from contrastors_tpu_torch.parallel.collectives import all_reduce_grads, group_rank, group_size, reduce_metrics
from contrastors_tpu_torch.parallel.mesh import fingerprint, make_mesh, replicate, shard_batch
from contrastors_tpu_torch.parallel.sharding import (
    gather_state_dict,
    gather_tensors,
    load_whole_optimizer_state,
    optimizer_params,
    param_splits,
    shard_module,
    shard_optimizer_state,
    shard_state_dict,
    whole_optimizer_state,
)
from contrastors_tpu_torch.utils import dist as dist_utils
from contrastors_tpu_torch.utils.logging import Tracker
from contrastors_tpu_torch.utils.optim import AdamW, lr_scheduler, make_optimizer, make_schedule
from contrastors_tpu_torch.utils.prefetch import PrefetchIterator

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Any, Optional[torch.Generator]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_standard_train_step(
    loss_fn: LossFn,
    optimizer: AdamW,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    gradient_accumulation_steps: int = 1,
    post_update: Optional[Callable[[], None]] = None,
    group=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, generator=None) -> metrics, which updates the
    parameters of `optimizer` in place every gradient_accumulation_steps
    calls, then runs post_update() (in-place, e.g. a clamp). `generator`
    is the trainer's: each call draws the step's generator from it
    (`ops/dropout.py:step_generator`; None without one).
    loss_fn(batch, step_generator) -> (loss, metrics); the step's metrics are
    those plus "loss" and, on an update, "grad_norm". Its phases are the
    profiler ranges "train_step/forward", "train_step/backward" and
    "train_step/optimizer".

    With a process group (the data axis) loss_fn returns this rank's loss
    as a lone process would on its rows: a mean whose mean over the ranks
    is the global batch's loss (a loss that is not, such as a mean over a
    count that differs by rank, weighs itself; see `trainers/mlm.py`). The
    step backpropagates it divided by the world size, folds the rank into
    the step generator, sums the gradients over the ranks once per update
    ("train_step/all_reduce", after the last micro-step), and averages the
    metrics over the ranks (`parallel/collectives.py:reduce_metrics`)."""
    ga = max(1, int(gradient_accumulation_steps or 1))
    params = optimizer_params(optimizer)
    rank = None if group is None else group_rank(group)
    world = group_size(group)
    micro = 0

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        nonlocal micro
        if micro % ga == 0:
            optimizer.zero_grad(set_to_none=True)
        with record_function("train_step/forward"):
            loss, metrics = loss_fn(batch, None if generator is None else step_generator(generator, rank))
        with record_function("train_step/backward"):
            # adds this micro-batch's gradients into .grad; summed over the
            # ranks, the world's shares give the global loss's gradients
            (loss / world if world > 1 else loss).backward()
        micro += 1
        metrics = reduce_metrics({**metrics, "loss": loss.detach()}, group)
        if micro % ga == 0:
            if group is not None:
                with record_function("train_step/all_reduce"):
                    all_reduce_grads(params, group)
            with record_function("train_step/optimizer"):
                if ga > 1:
                    torch._foreach_div_([p.grad for p in params if p.grad is not None], float(ga))
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
                if post_update is not None:
                    post_update()
            metrics["grad_norm"] = optimizer.grad_norm
        return metrics

    return step


# -- checkpoint writes --------------------------------------------------------
# Writes in flight, by path, shared by every trainer of the process so that
# a load waits for a save made by another trainer object.
_PENDING: Dict[str, threading.Thread] = {}
_PENDING_ERRORS: Dict[str, BaseException] = {}
_PENDING_LOCK = threading.Lock()


def _to_host(obj):
    """A copy of obj with every tensor on the CPU (dicts, lists, tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def wait_pending_saves(path: Optional[str] = None):
    """Block until the write of `path` (every write, with None) is on disk;
    raise the error of a write that failed."""
    with _PENDING_LOCK:
        items = [(p, t) for p, t in _PENDING.items() if path is None or p == path]
    for p, t in items:
        t.join()
        with _PENDING_LOCK:
            _PENDING.pop(p, None)
            err = _PENDING_ERRORS.pop(p, None)
        if err is not None:
            raise RuntimeError(f"the checkpoint write to {p} failed") from err


def _write_async(path: str, state: Dict[str, Any]):
    def write():
        try:
            torch.save(state, path)
        except BaseException as e:  # noqa: BLE001 - raised by wait_pending_saves
            with _PENDING_LOCK:
                _PENDING_ERRORS[path] = e

    thread = threading.Thread(target=write, daemon=False)
    with _PENDING_LOCK:
        _PENDING[path] = thread
    thread.start()


class BaseTrainer(ABC):
    def __init__(self, config: Config, dtype: str = "bf16", device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None and dist_utils.is_initialized():
            # a rank's "cuda" is its own card, made current by maybe_initialize_distributed
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.dtype = DTYPES[dtype]
        ta = config.train_args
        self.seed = ta.seed if ta.seed is not None else getattr(config.data_args, "seed", 42)
        self.generator = torch.Generator().manual_seed(self.seed)

        pa = config.parallel_args
        self.mesh = make_mesh(pa.data, pa.tensor, pa.expert)
        # the data axis' group: None for a lone process or a data axis of 1
        # beside other axes; at world size 1 in a process group the
        # collectives run on the one rank
        self.group = self.mesh.group
        self.is_main = self.mesh.global_rank == 0
        batch = getattr(config.data_args, "batch_size", None)
        if batch and batch % self.mesh.data:
            raise ValueError(f"data_args.batch_size={batch} (the global batch) does not divide over "
                             f"{self.mesh.data} ranks")
        # moe_impl="auto": dropless (the grouped-matmul kernels) with no
        # expert axis, capacity under it, as JAX resolves it
        for margs_ in (config.model_args, config.text_model_args, config.vision_model_args,
                       config.tower_model_args):
            if margs_ is not None and margs_.moe_impl == "auto":
                margs_.moe_impl = "capacity" if self.mesh.expert > 1 else "dropless"
                if margs_.num_experts:
                    dist_utils.rank0_print(f"[moe] moe_impl=auto -> {margs_.moe_impl} "
                                           f"(expert axis = {self.mesh.expert})")

        self.tokenizer = self.get_tokenizer()
        self.dataloader, self.steps_per_epoch = self.get_dataloaders()
        self.total_steps = ta.num_train_steps or (ta.num_epochs * self.steps_per_epoch)

        self.model = self.get_model()
        self._place_model()
        warmup = ta.warmup_steps or (int(self.total_steps * ta.warmup_pct) if ta.warmup_pct else 0)
        self.schedule = make_schedule(ta.schedule_type, ta.learning_rate, self.total_steps, warmup,
                                      ta.cooldown_steps)
        # total_steps, warmup and the logged lr count loop steps, but the
        # scheduler steps once per applied update, one per
        # gradient_accumulation_steps loop steps: it gets schedule(count * ga).
        # A custom step that updates every loop step cannot take ga > 1.
        ga = ta.gradient_accumulation_steps or 1
        if ga > 1 and not self._uses_grad_accumulation():
            raise ValueError(
                "gradient_accumulation_steps > 1 is not supported by this "
                "trainer's custom train step (grad-cache / dual-encoder / "
                "distill apply an optimizer update every loop step); raise "
                "chunk_size or batch_size instead"
            )
        opt_schedule = (lambda count: self.schedule(count * ga)) if ga > 1 else self.schedule
        self.optimizer = make_optimizer(
            self.model.named_parameters(),
            ta.learning_rate,
            weight_decay=ta.weight_decay,
            beta1=ta.adam_beta1,
            beta2=ta.adam_beta2,
            eps=ta.eps,
            max_grad_norm=ta.max_grad_norm,
            frozen_mask=self.frozen_mask(),
        )
        if pa.shard_optimizer_state:
            self.optimizer = shard_optimizer_state(self.optimizer, self.mesh, pa.opt_state_shard_min_size)
        self.scheduler = lr_scheduler(self.optimizer, opt_schedule)
        self.step = 0

        margs = config.model_args or config.text_model_args
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if margs is not None and margs.ema:
            self.ema_params = {n: p.detach().clone() for n, p in self.model.named_parameters()}
            self._ema_decay = float(margs.ema_decay)

        self.prefetch_wait_seconds = 0.0
        self.tracker = None if not self.is_main else Tracker(
            enabled_wandb=ta.wandb,
            project=ta.wandb_project_name,
            entity=ta.wandb_entity,
            run_name=ta.wandb_run_name,
            group=ta.wandb_group,
            output_dir=ta.output_dir,
            hyperparams=config.to_dict(),
            print_every=ta.log_lr_every,
        )
        if ta.checkpoint:
            self.load_state(ta.checkpoint)

    def placed_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules that are broadcast and split over the mesh: the
        model, and any other module the step runs (the distill teacher)."""
        return {"model": self.model}

    def _place_model(self):
        """Broadcast every parameter and buffer of the whole modules from
        global rank 0, then slice them for this rank (`shard_module`). Each
        rank built them from the same seed, so their checksums should agree
        before (`init_replicas_agreed`); after the broadcast they must."""
        self.init_replicas_agreed = True
        modules = list(self.placed_modules().values())
        if dist_utils.world() > 1:
            tensors = lambda: [t for m in modules for t in list(m.parameters()) + list(m.buffers())]  # noqa: E731
            before = dist_utils.gather_objects(fingerprint(tensors()))
            for m in modules:
                replicate(m, self.mesh)
            after = dist_utils.gather_objects(fingerprint(tensors()))
            self.init_replicas_agreed = len(set(before)) == 1
            if len(set(after)) != 1:
                raise RuntimeError(f"the replicas' parameters differ after the broadcast from rank 0: {after}")
            if not self.init_replicas_agreed:
                dist_utils.rank0_print(f"[trainer] the ranks built different initial parameters {before}; "
                                       "rank 0's were broadcast")
        for m in modules:
            shard_module(m, self.mesh)

    def log(self, metrics: Dict[str, Any], step: int):
        """Log on rank 0 (the only tracker)."""
        if self.tracker is not None:
            self.tracker.log(metrics, step)

    # -- hooks ---------------------------------------------------------------
    def get_tokenizer(self):
        margs = self.config.model_args or self.config.text_model_args
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(margs.tokenizer_name or margs.model_name)

    def load_dataset(self, path: str):
        """The data of a `datasets.save_to_disk` directory: a DatasetDict of
        splits or one Dataset. The MLM, MMLM and GLUE trainers read disk
        data only through this hook, so a subclass can hand in splits held
        in memory (rows by a list of indices, as a dict of columns)."""
        from datasets import load_from_disk

        return load_from_disk(path)

    def frozen_mask(self) -> Optional[Dict[str, bool]]:
        """{parameter name: trainable}; None = all trainable."""
        return None

    @abstractmethod
    def get_model(self) -> torch.nn.Module:
        """-> the module that holds every parameter the optimizer sees."""

    @abstractmethod
    def get_dataloaders(self):
        """-> (iterable of host batches, steps_per_epoch)"""

    @abstractmethod
    def make_train_step(self) -> Callable[[Batch, torch.Generator], Dict[str, torch.Tensor]]:
        """-> step(device batch, generator) -> metrics (device tensors),
        updating the modules in place."""

    def transform_host_batch(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host-side (numpy) batch rewrite before the copy to the device.
        Runs in the prefetch thread. Default: identity."""
        return host_batch

    def eval_loop(self, step: int) -> Dict[str, float]:
        return {}

    def _uses_grad_accumulation(self) -> bool:
        """True when the train step honours gradient_accumulation_steps."""
        return True

    # -- checkpoints -----------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        """The checkpoint: the model, its optimizer state and the EMA as
        whole tensors (a collective over the mesh's groups: every rank
        calls it)."""
        state = {"model": gather_state_dict(self.model, self.mesh),
                 "optimizer": whole_optimizer_state(self.optimizer, self.mesh),
                 "scheduler": self.scheduler.state_dict(), "generator": self.generator.get_state(),
                 "layout": list(self.mesh.layout)}
        if self.ema_params is not None:
            state["ema"] = gather_tensors(self.ema_params, param_splits(self.model), self.mesh)
        return state

    def save_state(self, out_dir: str, step: int):
        path = os.path.abspath(os.path.join(out_dir, f"step_{step}"))
        os.makedirs(path, exist_ok=True)
        state_path = os.path.join(path, "state.pt")
        wait_pending_saves()  # at most one write in flight
        state = self._state()
        if self.is_main:
            state = _to_host(state)
            if self.config.train_args.async_checkpointing:
                _write_async(state_path, state)
            else:
                torch.save(state, state_path)
        if hasattr(self.dataloader, "save_state") and self.mesh.leads_data_rank:
            self.dataloader.save_state(path)  # each data rank its own cursor
        if self.is_main:
            with open(os.path.join(path, "step.txt"), "w") as f:
                f.write(str(step))
            if hasattr(self, "trunk_config"):
                with open(os.path.join(path, "trunk_config.json"), "w") as f:
                    f.write(self.trunk_config.to_json())

    def load_state(self, path: str):
        path = os.path.abspath(path)
        state_path = os.path.join(path, "state.pt")
        wait_pending_saves(state_path)  # a just-written checkpoint may still be in flight
        dist_utils.barrier()  # ... on every rank
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        layout, saved = tuple(self.mesh.layout), tuple(state.get("layout", (self.mesh.data, 1, 1)))
        if saved[0] != layout[0]:
            raise ValueError(
                f"{path} was written at (data, expert, tensor) = {saved}; this run is at {layout}: a "
                "checkpoint resumes at the same data axis (the data cursors are per data rank), at any "
                "expert and tensor axes")
        splits = param_splits(self.model)
        self.model.load_state_dict(shard_state_dict(state["model"], self.mesh, splits))
        load_whole_optimizer_state(self.optimizer, state["optimizer"], self.mesh)
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        if self.ema_params is not None:
            for n, v in shard_state_dict(state["ema"], self.mesh, splits).items():
                self.ema_params[n].copy_(v)
        if hasattr(self.dataloader, "load_state"):
            self.dataloader.load_state(path)
        step_file = os.path.join(path, "step.txt")
        if os.path.exists(step_file):
            with open(step_file) as f:
                self.step = int(f.read().strip())
        dist_utils.rank0_print(f"[trainer] resumed from {path} at step {self.step}")

    def _ema_update(self):
        names = list(self.ema_params)
        params = dict(self.model.named_parameters())
        torch._foreach_lerp_([self.ema_params[n] for n in names], [params[n].detach() for n in names],
                             1.0 - self._ema_decay)

    # -- loop ------------------------------------------------------------------
    def _prepare(self, host_batch: Dict[str, Any]):
        """(meta, examples, tensors) of one host batch, in the prefetch
        thread: transformed, arrays as CPU tensors, pinned for a card."""
        host_batch = self.transform_host_batch(host_batch)
        meta = {k: v for k, v in host_batch.items() if not isinstance(v, np.ndarray)}
        arrays = {k: v for k, v in host_batch.items() if isinstance(v, np.ndarray)}
        # count examples, not rows of an arbitrary array (documents carry
        # B * (1 + negatives) rows; packed batches carry rows and pair indices)
        key = next((k for k in ("query_pair_index", "query_input_ids", "input_ids") if k in arrays),
                   next(iter(arrays)))
        tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
        if self.device.type == "cuda":
            tensors = {k: v.pin_memory() for k, v in tensors.items()}
        return meta, arrays[key].shape[0], tensors

    def _batches(self):
        depth = self.config.parallel_args.prefetch
        if depth and depth > 0:
            return PrefetchIterator(iter(self.dataloader), transform=self._prepare, depth=depth)
        return map(self._prepare, iter(self.dataloader))

    def _next_batch(self):
        try:
            return next(self._data_iter)
        except StopIteration:  # epoch end: start the next one
            self._close_batches()
            self._data_iter = self._batches()
            return next(self._data_iter)

    def _close_batches(self):
        it = self._data_iter
        if isinstance(it, PrefetchIterator):
            self.prefetch_wait_seconds += it.wait_seconds
            it.close()

    def train(self) -> int:
        ta = self.config.train_args
        profiler = None
        if ta.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        train_step = None
        last_log = time.time()
        examples = 0
        lang_losses: Dict[str, list] = {}  # per-language device scalars since the last log
        self._data_iter = self._batches()
        try:
            while self.step < self.total_steps:
                meta, n_examples, tensors = self._next_batch()
                if train_step is None:
                    train_step = self.make_train_step()
                if meta.get("cursor_snapshot") is not None and hasattr(self.dataloader, "note_consumed"):
                    # the cursor of the batch being trained on, not of the
                    # prefetch thread's read-ahead
                    self.dataloader.note_consumed(meta["cursor_snapshot"])
                batch = shard_batch(tensors, self.mesh, self.device)  # this rank's rows, to its device
                metrics = train_step(batch, self.generator)
                self.step += 1
                examples += n_examples * self.mesh.data
                if meta.get("lang"):
                    lang_losses.setdefault(meta["lang"], []).append(metrics["loss"])
                if self.ema_params is not None:
                    self._ema_update()

                if self.step % ta.log_lr_every == 0:
                    now = time.time()
                    metrics = dict(metrics)
                    metrics["lr"] = self.schedule(self.step)
                    metrics["examples_per_sec"] = examples / (now - last_log)
                    if meta.get("dataset_name") and "accuracy" in metrics:
                        metrics[f"accuracy/{meta['dataset_name']}"] = metrics.pop("accuracy")
                    for lang, values in lang_losses.items():
                        metrics[f"loss/{lang}"] = torch.stack(values).float().mean()
                    lang_losses.clear()
                    self.log(metrics, self.step)
                    last_log = now
                    examples = 0

                if ta.save_every and self.step % ta.save_every == 0 and ta.output_dir:
                    self.save_state(ta.output_dir, self.step)

                eval_due = (
                    ta.eval_strategy == "steps" and ta.eval_steps and self.step % ta.eval_steps == 0
                ) or (
                    ta.eval_strategy == "epochs" and self.steps_per_epoch
                    and self.step % self.steps_per_epoch == 0
                )
                if eval_due:
                    # host numbers of each rank, averaged (train metrics are
                    # reduced in the step)
                    eval_metrics = dist_utils.process_allmean(self.eval_loop(self.step))
                    if eval_metrics:
                        self.log(eval_metrics, self.step)

                if ta.profile and self.step >= 10:
                    break
        finally:
            self._close_batches()
        if profiler is not None:
            profiler.stop()
            trace_dir = os.path.join(ta.output_dir or ".", "trace")
            os.makedirs(trace_dir, exist_ok=True)
            name = "trace.json" if dist_utils.world() == 1 else f"trace_rank_{self.mesh.global_rank}.json"
            profiler.export_chrome_trace(os.path.join(trace_dir, name))
            print(f"[trainer] profile written to {trace_dir}")
        if ta.output_dir:
            self.save_state(ta.output_dir, self.step)
        wait_pending_saves()  # the final checkpoint is on disk at exit
        dist_utils.barrier()  # ... every rank's part of it
        if self.tracker is not None:
            self.tracker.finish()
        return self.step
