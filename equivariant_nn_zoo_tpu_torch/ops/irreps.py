"""Irreducible representations of O(3) — the static algebra layer.

This replaces ``e3nn.o3.Irreps`` (reference: e3_layers uses e3nn 0.4.4 for
irreps bookkeeping throughout, e.g. e3_layers/nn/sequential.py:6,
e3_layers/nn/pointwise.py:3).  Everything here is *static* Python — it runs
once at model construction, so the classes are plain hashable tuples.
Carried over from the JAX package unchanged (numpy only), because the
machine that runs the port has no jax.

Conventions
-----------
- An irrep is ``(l, p)`` with degree ``l >= 0`` and parity ``p ∈ {+1, -1}``,
  printed ``"{l}{e|o}"``.
- The real basis for ``l=1`` is ordered ``(x, y, z)`` so that the Wigner
  matrix of a rotation R on a ``1o`` feature is R itself: positions and
  displacement vectors ARE irrep arrays, no reordering.
- Data arrays carrying irreps are ``[..., irreps.dim]`` with the multiplicity
  (channel) index varying slowest inside each irrep block: a ``64x1o`` slice
  is reshaped ``[..., 64, 3]``.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Iterator, List, Sequence, Tuple, Union


class Irrep(tuple):
    """A single irreducible representation (l, p) of O(3)."""

    def __new__(cls, l, p=None):
        if p is None:
            if isinstance(l, Irrep):
                return l
            if isinstance(l, str):
                name = l.strip()
                m = re.fullmatch(r"(\d+)([eo])", name)
                if m is None:
                    raise ValueError(f"invalid irrep string {l!r}")
                l = int(m.group(1))
                p = 1 if m.group(2) == "e" else -1
            elif isinstance(l, tuple):
                l, p = l
            else:
                raise ValueError(f"cannot interpret {l!r} as an Irrep")
        if not (isinstance(l, int) and l >= 0):
            raise ValueError(f"invalid degree {l!r}")
        if p not in (1, -1):
            raise ValueError(f"invalid parity {p!r}")
        return super().__new__(cls, (l, p))

    @property
    def l(self) -> int:  # noqa: E743
        return self[0]

    @property
    def p(self) -> int:
        return self[1]

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __repr__(self):
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __mul__(self, other) -> Iterator["Irrep"]:
        """Selection rule: yields irreps in the tensor product self ⊗ other."""
        other = Irrep(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def __contains__(self, _):  # pragma: no cover
        raise NotImplementedError

    @classmethod
    def iterator(cls, lmax: int) -> Iterator["Irrep"]:
        for l in range(lmax + 1):
            for p in (1, -1):
                yield Irrep(l, p)


class MulIrrep(tuple):
    """(multiplicity, Irrep) pair."""

    def __new__(cls, mul: int, ir=None):
        if ir is None:
            mul, ir = mul
        return super().__new__(cls, (int(mul), Irrep(ir)))

    @property
    def mul(self) -> int:
        return self[0]

    @property
    def ir(self) -> Irrep:
        return self[1]

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self):
        return f"{self.mul}x{self.ir}"


class Irreps(tuple):
    """A direct sum of irreps with multiplicities, e.g. ``"64x0e+64x1o"``.

    Immutable and hashable: safe to close over in jitted functions and to use
    as static config.  Mirrors the subset of e3nn.o3.Irreps the reference
    relies on (dim, num_irreps, slices, sort, simplify, +, lmax,
    spherical_harmonics, count).
    """

    def __new__(cls, irreps=None):
        if isinstance(irreps, Irreps):
            return irreps
        out: List[MulIrrep] = []
        if irreps is None:
            pass
        elif isinstance(irreps, Irrep):
            out.append(MulIrrep(1, irreps))
        elif isinstance(irreps, str):
            s = irreps.strip()
            if s:
                for term in s.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul, ir = term.split("x")
                        out.append(MulIrrep(int(mul), Irrep(ir)))
                    else:
                        out.append(MulIrrep(1, Irrep(term)))
        else:
            for item in irreps:
                out.append(MulIrrep(*item) if not isinstance(item, MulIrrep) else item)
        return super().__new__(cls, out)

    def __repr__(self):
        return "+".join(repr(mi) for mi in self) if len(self) else "(empty)"

    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        if len(self) == 0:
            raise ValueError("empty irreps has no lmax")
        return max(mi.ir.l for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    def slices(self) -> List[slice]:
        out = []
        start = 0
        for mi in self:
            out.append(slice(start, start + mi.dim))
            start += mi.dim
        return out

    def count(self, ir) -> int:
        ir = Irrep(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, ir) -> bool:
        if isinstance(ir, (Irrep, str)):
            ir = Irrep(ir)
            return any(mi.ir == ir and mi.mul > 0 for mi in self)
        return super().__contains__(ir)

    def __add__(self, other) -> "Irreps":
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def __mul__(self, n: int) -> "Irreps":
        return Irreps(tuple(self) * n)

    def simplify(self) -> "Irreps":
        out: List[List] = []
        for mi in self:
            if out and out[-1][1] == mi.ir:
                out[-1][0] += mi.mul
            elif mi.mul > 0:
                out.append([mi.mul, mi.ir])
        return Irreps([MulIrrep(m, ir) for m, ir in out])

    def remove_zero_multiplicities(self) -> "Irreps":
        return Irreps([mi for mi in self if mi.mul > 0])

    def sort(self):
        """Stable sort by (l, p). Returns (irreps, p, inv) like e3nn."""
        order = sorted(range(len(self)), key=lambda i: (self[i].ir.l, -self[i].ir.p))
        inv = tuple(order)
        p = [0] * len(self)
        for new_pos, old_pos in enumerate(order):
            p[old_pos] = new_pos
        irreps = Irreps([self[i] for i in order])

        class _Sorted(tuple):
            pass

        res = _Sorted((irreps, tuple(p), inv))
        res.irreps, res.p, res.inv = irreps, tuple(p), inv
        return res

    @classmethod
    def spherical_harmonics(cls, lmax: int, p: int = -1) -> "Irreps":
        return cls([(1, (l, p**l)) for l in range(lmax + 1)])


IrrepsLike = Union[str, Irreps, Sequence]


@lru_cache(maxsize=None)
def _tp_path_exists(irreps_in1: Irreps, irreps_in2: Irreps, ir_out: Irrep) -> bool:
    for mi1 in irreps_in1:
        for mi2 in irreps_in2:
            if ir_out in mi1.ir * mi2.ir:
                return True
    return False


def tp_path_exists(irreps_in1, irreps_in2, ir_out) -> bool:
    """Whether ir_out appears in the tensor product of the two irreps.

    Reference parity: e3_layers/utils/utils.py:87-96.
    """
    return _tp_path_exists(
        Irreps(irreps_in1).simplify(), Irreps(irreps_in2).simplify(), Irrep(ir_out)
    )


def irreps_dim(irreps_or_int) -> int:
    """Dimension of an attrs annotation: int, digit-string, or irreps string.

    Reference parity: e3_layers/data/data.py:73-85 (num_dims).
    """
    x = irreps_or_int
    if isinstance(x, int):
        return x
    if isinstance(x, str) and x.isdigit():
        return int(x)
    return Irreps(x).dim
