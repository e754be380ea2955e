"""The benchmark's general generator: weights and batches from ``--seed``.

Every tensor is drawn on the device by a ``torch.Generator`` of its own,
seeded from a hash of (seed, grid model, name), so a leaf or a batch can
be drawn again alone: the reference regenerates exactly what the program
was handed.  Weights come in one call per stacked leaf, in f32.  The
layout of a family's weights and batches is its file under
``bench/init/``, named by the configuration's ``init``.

A traffic mix is a data file (``bench/traffic/<mix>.json``); its numbers
(sequence length, batch, steps, learning rates) reach the program only
through this one generator.  Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import importlib
import math

import torch


def family(name: str):
    """The family file ``bench/init/<name>.py``."""
    return importlib.import_module(f"bench.init.{name}")


def derive_seed(*parts) -> int:
    """A 63-bit seed from ``parts`` (any seed given on the command line,
    however large, and the names that pick one tensor)."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(*parts))


def weight_bytes(fam, arch: dict) -> int:
    return sum(4 * math.prod(shape)
               for _, shape, _, _ in fam.weight_specs(arch))


def make_leaf(fam, arch: dict, seed: int, model: int, name: str, device):
    """One stacked leaf of grid model ``model``, drawn again alone."""
    for n, shape, kind, std in fam.weight_specs(arch):
        if n == name:
            if kind == "normal":
                t = torch.randn(shape, device=device, dtype=torch.float32,
                                generator=generator(device, seed, model, n))
                return t.mul_(std)
            fill = torch.ones if kind == "ones" else torch.zeros
            return fill(shape, dtype=torch.float32, device=device)
    raise KeyError(name)


def make_weights(fam, arch: dict, seed: int, model: int, device) -> dict:
    """The nested f32 weight tree of grid model ``model``."""
    tree: dict = {}
    for name, _, _, _ in fam.weight_specs(arch):
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = make_leaf(fam, arch, seed, model, name, device)
    return tree


def make_batch(fam, arch: dict, seq: int, batch: int, seed: int, model: int,
               step: int, device) -> dict:
    """Batch ``step`` of grid model ``model``."""
    g = generator(device, seed, model, "batch", step)
    return fam.make_batch(arch, seq, batch, g, device)


class Batches:
    """The closed-loop feed of one grid model: batch k is drawn when the
    program asks for its k-th minibatch.  ``on_next`` (if given) is told
    the index first and may end the feed by raising StopIteration."""

    def __init__(self, fam, arch, seq, batch, seed, model, device,
                 on_next=None):
        self.fam, self.arch, self.seq, self.batch = fam, arch, seq, batch
        self.seed, self.model, self.device = seed, model, device
        self.on_next = on_next
        self.drawn = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.on_next is not None:
            self.on_next(self.drawn)
        b = make_batch(self.fam, self.arch, self.seq, self.batch, self.seed,
                       self.model, self.drawn, self.device)
        self.drawn += 1
        return b
