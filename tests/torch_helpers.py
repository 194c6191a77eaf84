"""Shared inputs for the port's tests (tests/test_torch_*.py)."""

import random

import torch

from spartan2_tpu_torch.frontend.constraint_system import ONE, Num, lc

# The suite runs in several worker processes beside XLA:CPU compiles;
# torch's own thread pool would oversubscribe the cores and stall.
torch.set_num_threads(1)


class CubicCircuit:
    """x^3 + x + 5 = y with y = 15 public (reference spartan.rs:590-652),
    written against the port's frontend."""

    def public_values(self):
        return [15]

    def shared(self, cs):
        return []

    def precommitted(self, cs, shared):
        return []

    def num_challenges(self):
        return 0

    def synthesize(self, cs, shared, precommitted, challenges):
        x = Num.alloc(cs, 2)
        x_sq = x.square(cs)
        x_cu = x_sq.mul(cs, x)
        y = Num.alloc(cs, None if cs.shape_mode
                      else (x_cu.value + x.value + 5) % cs.field.modulus)
        cs.enforce(lc((1, x_cu.var), (1, x.var), (5, ONE)), lc((1, ONE)),
                   lc((1, y.var)))
        y.inputize(cs)


class SquareStepCircuit:
    """y = x^2 + 3 with y public (tests/test_neutronnova.py's step circuit,
    written against the port's frontend)."""

    def __init__(self, x: int):
        self.x = x

    def public_values(self):
        return [self.x * self.x + 3]

    def shared(self, cs):
        return []

    def precommitted(self, cs, shared):
        return []

    def num_challenges(self):
        return 0

    def synthesize(self, cs, shared, precommitted, challenges):
        x = Num.alloc(cs, self.x)
        x_sq = x.square(cs)
        y = Num.alloc(cs, None if cs.shape_mode else (x_sq.value + 3) % cs.field.modulus)
        cs.enforce(lc((1, x_sq.var), (3, ONE)), lc((1, ONE)), lc((1, y.var)))
        y.inputize(cs)


class CoreCircuit:
    """y = a * b with y = 42 public (tests/test_neutronnova.py)."""

    def public_values(self):
        return [42]

    def shared(self, cs):
        return []

    def precommitted(self, cs, shared):
        return []

    def num_challenges(self):
        return 0

    def synthesize(self, cs, shared, precommitted, challenges):
        a = Num.alloc(cs, 6)
        b = Num.alloc(cs, 7)
        y = a.mul(cs, b)
        y.inputize(cs)


class PrecommittedStepCircuit:
    """y = x^2 + 3 with the whole witness in the precommitted phase and
    six pinned extra variables (tests/test_neutronnova.py): the rest
    segment is all padding, so the prover takes the truncated fold."""

    def __init__(self, x: int):
        self.x = x

    def public_values(self):
        return [self.x * self.x + 3]

    def shared(self, cs):
        return []

    def precommitted(self, cs, shared):
        x = Num.alloc(cs, self.x)
        x_sq = x.square(cs)
        y = Num.alloc(cs, None if cs.shape_mode else (x_sq.value + 3) % cs.field.modulus)
        cs.enforce(lc((1, x_sq.var), (3, ONE)), lc((1, ONE)), lc((1, y.var)))
        y.inputize(cs)
        for i in range(6):
            t = Num.alloc(cs, i)
            cs.enforce(lc((1, t.var)), lc((1, ONE)), lc((i, ONE)))
        return []

    def num_challenges(self):
        return 0

    def synthesize(self, cs, shared, precommitted, challenges):
        return None


def det(seed: int):
    """bench.py's deterministic blind source: rng(q) -> int in [0, q)."""
    r = random.Random(seed)
    return lambda q: r.randrange(q)


def rand_ints(p: int, n: int, seed: int) -> list[int]:
    r = random.Random(seed)
    return [r.randrange(p) for _ in range(n)]


def mont_vector(spec, n: int, seed: int):
    """n seeded canonical ints and their (n, 8) Montgomery tensor on the CPU."""
    from spartan2_tpu_torch.field.limbs import to_device

    vals = rand_ints(spec.modulus, n, seed)
    return vals, to_device(vals, spec, "cpu", mont=True)


def taus_with_0_and_1(p: int, m: int, seed: int) -> list[int]:
    """Seeded taus with tau_0 = 0 and tau_1 = 1: the Gruen prover's t(-1)
    fallback and a zero eq slope term, which the JAX package's fused provers
    refuse."""
    taus = rand_ints(p, m, seed)
    taus[0], taus[1] = 0, 1
    return taus


class ChainCircuit:
    """x -> x^2, n times from x0, the last value public (tests/test_mesh.py's
    ChainCircuit with n = 1000 and x0 = 3, and its ChainStep with n = 62),
    written against the port's frontend."""

    def __init__(self, x0: int = 3, n: int = 1000, modulus: int | None = None):
        self.x0, self.n = x0, n
        if modulus is None:
            from spartan2_tpu_torch.provider.engines import get_engine

            modulus = get_engine("PallasHyraxEngine").scalar.modulus
        self.modulus = modulus

    def public_values(self):
        x = self.x0
        for _ in range(self.n):
            x = x * x % self.modulus
        return [x]

    def shared(self, cs):
        return []

    def precommitted(self, cs, shared):
        return []

    def num_challenges(self):
        return 0

    def synthesize(self, cs, shared, precommitted, challenges):
        x = Num.alloc(cs, self.x0)
        for _ in range(self.n):
            x = x.square(cs)
        x.inputize(cs)
