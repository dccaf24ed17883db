"""Integer interval lattice for word-level range analysis.

The abstract domain is closed integer intervals [lo, hi] ordered by
inclusion. Every transfer function here is *sound*: if a concrete value v
lies in the input interval, the transformed value lies in the output
interval. Two transfers are additionally *exact* in ways the analyzer
exploits:

  * saturate clamp: monotone, so clamping the endpoints clamps the set.
  * wrap clamp: ``((v - V_MIN) % V_SPAN) + V_MIN`` is a translation on any
    interval that stays inside a single wrap window (the half-open spans
    ``[V_MIN + k*V_SPAN, V_MIN + (k+1)*V_SPAN)``); crossing a window
    boundary splits the image into two arcs whose hull is the full 11-bit
    domain — sound, and the only over-approximation wrap introduces.

Because 2^11 divides 2^32, int32 two's-complement overflow is itself a
wrap mod a multiple of V_SPAN, so wrap-mode V words survive int32 overflow
unchanged (``v mod 2^32 mod 2^11 == v mod 2^11``). Saturate mode has no
such luck: an accumulator that overflows *before* the clip clips the wrong
value, which is exactly what `program_check` must prove cannot happen.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.quant import V_MAX, V_MIN, V_SPAN

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


class AnalysisError(ValueError):
    """Base class for every static-analysis rejection.

    Carries ``where`` — the layer / op / contract the verdict names — so
    callers (and tests) can assert the analyzer identified the offender,
    not merely that something failed.
    """

    def __init__(self, message: str, *, where: str = "") -> None:
        super().__init__(f"{where}: {message}" if where else message)
        self.where = where


@dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi] (requires lo <= hi)."""
    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    # --- lattice ---------------------------------------------------------
    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def intersect(self, other: "Interval") -> "Interval | None":
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        return Interval(lo, hi) if lo <= hi else None

    def contains(self, other: "Interval") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def contains_value(self, v: int) -> bool:
        return self.lo <= int(v) <= self.hi

    # --- arithmetic transfers (exact) ------------------------------------
    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __sub__(self, other: "Interval") -> "Interval":
        return Interval(self.lo - other.hi, self.hi - other.lo)

    def shift(self, k: int) -> "Interval":
        return Interval(self.lo + k, self.hi + k)

    def scale(self, k: int) -> "Interval":
        """Image under multiplication by an integer constant k."""
        a, b = self.lo * k, self.hi * k
        return Interval(min(a, b), max(a, b))

    @property
    def width(self) -> int:
        return self.hi - self.lo

    @property
    def magnitude(self) -> int:
        """max |v| over the interval."""
        return max(abs(self.lo), abs(self.hi))

    def __repr__(self) -> str:  # compact in reports
        return f"[{self.lo}, {self.hi}]"

    @staticmethod
    def point(v: int) -> "Interval":
        return Interval(int(v), int(v))


#: the 11-bit signed membrane word domain, [-1024, 1023]
V_DOMAIN = Interval(V_MIN, V_MAX)
#: the int32 accumulator domain every backend carries partials in
INT32 = Interval(INT32_MIN, INT32_MAX)


def clamp_interval(iv: Interval, mode: str) -> Interval:
    """Transfer function of `quant.clamp_v` on intervals.

    saturate is exact (monotone). wrap is exact iff the interval lies in
    one wrap window — ``floor((lo - V_MIN) / V_SPAN) ==
    floor((hi - V_MIN) / V_SPAN)`` — and widens to the full domain
    otherwise (the image is two arcs; we keep a single-interval lattice).
    """
    if mode == "saturate":
        return Interval(min(max(iv.lo, V_MIN), V_MAX),
                        min(max(iv.hi, V_MIN), V_MAX))
    if mode == "wrap":
        k_lo = (iv.lo - V_MIN) // V_SPAN
        k_hi = (iv.hi - V_MIN) // V_SPAN
        if k_lo == k_hi:
            return iv.shift(-k_lo * V_SPAN)
        return V_DOMAIN
    raise ValueError(f"unknown clamp mode {mode!r}")


def wrap_is_exact(iv: Interval) -> bool:
    """True when `clamp_interval(iv, "wrap")` loses no precision."""
    return (iv.lo - V_MIN) // V_SPAN == (iv.hi - V_MIN) // V_SPAN
