"""The served weights, made on the device from the run seed.

A reference family module lists its weights as groups: one leaf of every
layer that has it, under the port's parameter names.  Each group is one
draw from a ``torch.Generator`` of its own (seeded from the run seed and the
group's key), in the type it is served in, so the whole model takes a few
large calls, and any group can be drawn again alone with the same result.
Projections are N(0, scale^2); a ``"norm"`` group is 1 + N(0, 0.1^2).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Mapping, Sequence

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def group_seed(seed: int, key: str) -> int:
    salt = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
    state = np.random.SeedSequence([seed & (2**64 - 1), salt]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def draw(group, seed: int, device) -> torch.Tensor:
    """One group's leaves stacked: [len(names), *shape]."""
    key, names, shape, kind, scale = group
    g = torch.Generator(device=device).manual_seed(group_seed(seed, key))
    t = torch.randn((len(names), *shape), generator=g, dtype=DTYPES[kind], device=device)
    if scale == "norm":
        return t.mul_(0.1).add_(1.0)
    return t.mul_(scale)


def make(groups: Sequence, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor}, each a view into its group's draw."""
    return dict(Drawn(groups, seed, device).items())


class Drawn(Mapping):
    """The weights as a mapping that draws each group only while it is
    iterated and keeps nothing: a consumer that copies them into its own
    tensors (the engine's ``load_state_dict``) never holds two full copies
    longer than its own copy takes."""

    def __init__(self, groups: Sequence, seed: int, device):
        self.groups, self.seed, self.device = list(groups), seed, device
        self._names = [n for g in self.groups for n in g[1]]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, name: str) -> torch.Tensor:
        for g in self.groups:
            if name in g[1]:
                return draw(g, self.seed, self.device)[g[1].index(name)]
        raise KeyError(name)

    def items(self):
        for g in self.groups:
            yield from zip(g[1], draw(g, self.seed, self.device).unbind(0))
