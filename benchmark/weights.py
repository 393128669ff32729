"""Seeded weights, made on the device in one draw and handed alike to the
program and to the reference.

A configuration's parameters are listed by the reference (`specs`: name,
shape, init).  `draw` makes every "normal" entry from one `normal_` call
on a generator seeded from the run's seed, in the dtype the weights are
served in, and scales each slice by its standard deviation in that dtype;
the other entries are constants or, for a weight-normed conv's g, the
norm of its v.  The same seed on the same device gives the same bits, so
`fill_` (into the program's modules) and `tensors` (a float32 dict for the
reference) agree exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import torch

Spec = Tuple[str, tuple, tuple]


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one stream of a run (weights, codec, voices, ...)."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 62)


def draw(specs: List[Spec], seed: int, device, dtype
         ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor in `dtype`) for every spec, in order."""
    n = sum(_numel(shape) for _, shape, init in specs if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, dtype=dtype, device=device).normal_(generator=gen)
    normed = {init[1] for _, _, init in specs if init[0] == "norm_of"}
    made: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, init in specs:
        kind = init[0]
        if kind == "normal":
            k = _numel(shape)
            t = flat[off:off + k].view(shape) * init[1]
            off += k
            if name in normed:
                made[name] = t
        elif kind == "norm_of":
            v = made.pop(init[1]).float()
            t = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)),
                                     keepdim=True)).to(dtype)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "const":
            t = torch.full(shape, init[1], dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        yield name, t


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def fill_(module: torch.nn.Module, specs: List[Spec], seed: int,
          dtype) -> None:
    """Write the drawn weights into `module`'s parameters and buffers by
    name.  Every spec must name one; tensors of the module that no spec
    names are zeroed (the parts of the published checkpoint a cell never
    runs, such as the codec's encoder when voices come as latents)."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    seen = set()
    device = next(iter(own.values())).device
    for name, t in draw(specs, seed, device, dtype):
        if name not in own:
            raise KeyError(f"{name} is not a tensor of {type(module).__name__}")
        if tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: spec {tuple(t.shape)}, module "
                             f"{tuple(own[name].shape)}")
        own[name].copy_(t)
        seen.add(name)
    for name, p in own.items():
        if name not in seen:
            p.zero_()


def tensors(specs: List[Spec], seed: int, device, dtype,
            keep: Callable[[str], bool] = lambda name: True
            ) -> Dict[str, torch.Tensor]:
    """The drawn weights as a float32 dict (the reference's input)."""
    return {name: t.float() for name, t in draw(specs, seed, device, dtype)
            if keep(name)}


def pca(latent_size: int, codec_dim: int, seed: int, device) -> dict:
    """Unit-row PCA components, zero mean, scale 1 (float32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((latent_size, codec_dim), generator=gen, device=device,
                    dtype=torch.float32)
    return {"components": w / torch.linalg.vector_norm(w, dim=1, keepdim=True),
            "mean": torch.zeros((codec_dim,), dtype=torch.float32,
                                device=device),
            "latent_scale": 1.0}
