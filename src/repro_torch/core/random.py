"""The port's PRNG key: explicit, splittable, never a global generator.

The selection loop calls ``split`` with the same counts, in the same
order, as the JAX reference calls ``jax.random.split``, derives a key
per round or probe through ``fold_in`` where the reference calls
``jax.random.fold_in``, draws every Gumbel vector through ``gumbel`` and
every standard normal array (the coreset's random projection) through
``normal``.  Any object with these methods is a key, which is how a test
replays the reference's exact noise: it passes a key class that wraps
``jax.random`` (defined in the test, so this package never imports JAX).

    split(num) -> list[key]
    fold_in(i) -> key
    gumbel(n, device) -> (n,) f32 tensor on ``device``, i.i.d. Gumbel
    normal(shape, device) -> f32 tensor of ``shape`` on ``device``, N(0, 1)

A key that a checkpoint carries (the training loop's selection key) also
has ``as_array() -> numpy array`` and a classmethod ``from_array(a)``
that rebuilds it.

:class:`SeedKey` is the default: children derive deterministically from
an integer seed (splitmix64), and each draw seeds a fresh
``torch.Generator``.  CPU and CUDA generators give different streams for
one seed; ``host=True`` draws on the CPU and moves the noise to the
device, so a CPU run and a card run see the same noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
# Mixed into ``fold_in``'s children so that they never equal ``split``'s.
_FOLD_SALT = 0xD1B54A32D192ED03


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class Key(Protocol):
    def split(self, num: int) -> list["Key"]:
        """``num`` independent child keys."""

    def fold_in(self, i: int) -> "Key":
        """The child key for the integer ``i`` (a round, a probe)."""

    def gumbel(self, n: int, device) -> torch.Tensor:
        """(n,) f32 i.i.d. Gumbel noise on ``device``."""

    def normal(self, shape, device) -> torch.Tensor:
        """f32 i.i.d. standard normals of ``shape`` on ``device``."""


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms, clamped to [1e-9, 1 − 1e-9) as the
    reference's ``gumbel_noise`` does."""
    lo = 1e-9
    u = torch.clamp(u * ((1.0 - lo) - lo) + lo, min=lo)
    return -torch.log(-torch.log(u))


@dataclass(frozen=True)
class SeedKey:
    """Default key: an integer seed; ``host`` draws on the CPU."""

    seed: int
    host: bool = False

    def split(self, num: int) -> list["SeedKey"]:
        base = _splitmix64(self.seed & _MASK64)
        return [SeedKey(_splitmix64(base ^ _splitmix64(i + 1)), self.host)
                for i in range(int(num))]

    def fold_in(self, i: int) -> "SeedKey":
        base = _splitmix64((self.seed ^ _FOLD_SALT) & _MASK64)
        return SeedKey(_splitmix64(base ^ _splitmix64(int(i) & _MASK64)),
                       self.host)

    def as_array(self) -> np.ndarray:
        """(2,) uint64: the seed and the host flag (a checkpoint leaf)."""
        return np.array([self.seed & _MASK64, int(self.host)], np.uint64)

    @classmethod
    def from_array(cls, a) -> "SeedKey":
        a = np.asarray(a, np.uint64)
        return cls(int(a[0]), bool(a[1]))

    def _generator(self, device):
        dev = torch.device("cpu" if self.host else device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed & (_MASK64 >> 1))
        return gen, dev

    def gumbel(self, n: int, device) -> torch.Tensor:
        gen, dev = self._generator(device)
        u = torch.rand(int(n), generator=gen, device=dev, dtype=torch.float32)
        return gumbel_from_uniform(u).to(device)

    def normal(self, shape, device) -> torch.Tensor:
        gen, dev = self._generator(device)
        z = torch.randn(tuple(int(s) for s in shape), generator=gen,
                        device=dev, dtype=torch.float32)
        return z.to(device)
