"""Dropout and drop-path drawn from explicit generators.

Counterpart of flax's `nn.Dropout`, `contrastors_tpu/layers/block.py:_drop_path`
and the attention dropout of `contrastors_tpu/ops/sdpa.py`: every one of them
goes through `dropout` here. It is active only in training mode with p > 0,
keeps each element with probability 1 - p (drawn by `keep_mask` from the
generator it is given, on the tensor's device) and scales the kept ones by
1 / (1 - p); p = 1 gives zeros, as flax does. In training mode with p > 0 and
no generator it raises, as flax raises when no "dropout" rng is given.

Noise is a function of a generator's seed and the site that draws it, as
flax's is of the rng and the module path: `noise_seed` reads the seed of the
generator a caller passes (`initial_seed()`, a host value, so no device
sync), `fold_seed` derives a site's seed from it on the host, and
`site_generator` builds that site's generator. A model derives one seed per
block outside the block's call and builds the block's generators inside it,
so that the replay of `torch.utils.checkpoint`, which restores only the
global RNG state, draws the same noise.

A `GeneratorGroup` stands for m forwards in one: grad cache's pass 1 embeds
m chunks per call (`embed_parallel`), each of which must draw the noise its
own generator gives it alone, as JAX's `vmap` over the chunks' keys does.
Passed where a generator goes, its seed is a tuple (one per chunk) that
`fold_seed` and `site_generator` carry through to every site, and each site
draws its leading-dim row blocks from the chunks' generators in turn
(`draw`). The group carries noise only: grad cache tells the encoder the
chunk count on its own, for the MoE layers' routing.
"""

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


class GeneratorGroup:
    """The generators of m equal blocks of leading rows, in order."""

    def __init__(self, generators: Sequence[torch.Generator]):
        self.generators = list(generators)

    def __len__(self) -> int:
        return len(self.generators)


Seed = Union[int, Tuple[int, ...]]


def fold_seed(seed: Seed, *path: int) -> Seed:
    """A 64-bit seed for `path` under `seed`, on the host (JAX's fold_in);
    a tuple of seeds folds each."""
    if isinstance(seed, tuple):
        return tuple(fold_seed(s, *path) for s in seed)
    x = _mix(int(seed) & _M64)
    for p in path:
        x = _mix((x + 0x9E3779B97F4A7C15 * (int(p) + 1)) & _M64)
    return x


def noise_seed(generator) -> Optional[Seed]:
    """The seed a generator was seeded with (None for None; a tuple for a
    GeneratorGroup)."""
    if isinstance(generator, GeneratorGroup):
        return tuple(int(g.initial_seed()) for g in generator.generators)
    return None if generator is None else int(generator.initial_seed())


def site_generator(seed: Optional[Seed], *path: int, device):
    """The generator of the dropout site `path` under `seed`, on `device`
    (a GeneratorGroup for a tuple of seeds)."""
    if seed is None:
        return None
    if isinstance(seed, tuple):
        return GeneratorGroup([site_generator(s, *path, device=device) for s in seed])
    return torch.Generator(device=device).manual_seed(fold_seed(seed, *path))


def step_generator(generator: torch.Generator, rank: Optional[int] = None) -> torch.Generator:
    """The generator of one training step, seeded by one draw from the
    trainer's CPU generator (a host draw: no device sync). It carries only
    its seed: the sites build their generators on the tensors' device. A
    data-parallel rank folds its index into the seed, so that the ranks
    draw different noise for their different rows."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    if rank is not None:
        seed = fold_seed(seed, rank) >> 2
    return torch.Generator().manual_seed(seed)


def active(p: float, training: bool) -> bool:
    return training and p > 0.0


def need_generator(generator: Optional[torch.Generator], p: float, where: str = "dropout"):
    if generator is None:
        raise ValueError(f"{where} with p={p} in training mode needs a torch.Generator "
                         "(as flax needs a 'dropout' rng)")


def draw(fn: Callable[..., torch.Tensor], shape: Sequence[int], generator, device) -> torch.Tensor:
    """fn(shape, generator=, device=) (torch.rand, torch.randn); from a
    GeneratorGroup, each block of leading rows from its own generator."""
    if not isinstance(generator, GeneratorGroup):
        return fn(tuple(shape), generator=generator, device=device)
    m = len(generator)
    if shape[0] % m:
        raise ValueError(f"{shape[0]} rows do not split into {m} groups")
    block = (shape[0] // m,) + tuple(shape[1:])
    return torch.cat([fn(block, generator=g, device=device) for g in generator.generators])


def keep_mask(shape: Sequence[int], keep: float, generator, device) -> torch.Tensor:
    """Bool mask, True with probability `keep`, drawn from `generator`."""
    return draw(torch.rand, shape, generator, device) < keep


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator], training: bool = True,
            mask_shape: Optional[Sequence[int]] = None,
            mask_part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """x with each element (or each slice of `mask_shape`, broadcast over x:
    drop-path draws one per sample) zeroed with probability p and the rest
    divided by 1 - p. mask_part = (dim, start, whole): x is the slice
    [start, start + x.shape[dim]) along dim of a tensor `whole` long there;
    the mask is drawn for the whole and sliced (a tensor rank's heads)."""
    if not active(p, training):
        return x
    need_generator(generator, p)
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    shape = list(x.shape if mask_shape is None else mask_shape)
    if mask_part is not None:
        dim, start, whole = mask_part
        n, shape[dim] = shape[dim], whole
        mask = keep_mask(shape, keep, generator, x.device).narrow(dim, start, n)
    else:
        mask = keep_mask(shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], training: bool = True):
    """Per-sample stochastic depth (JAX `_drop_path`): one draw per row of
    the leading dim."""
    return dropout(x, rate, generator, training, mask_shape=(x.shape[0],) + (1,) * (x.ndim - 1))
