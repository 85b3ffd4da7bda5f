"""Early-stopping conditions for the Trainer.

A copy of ``equivariant_nn_zoo_tpu/run/early_stopping.py`` (plain Python).

Feature parity with the reference's C19 (SURVEY.md §2; e3_layers/run/
early_stopping.py): three condition kinds —

1. a watched metric dropping below a configured floor (``lower_bounds``),
2. a watched metric rising above a configured ceiling (``upper_bounds``),
3. a watched metric failing to improve by more than ``delta`` for
   ``patience`` consecutive evaluations (``patiences``).

Design here is a small object per condition (:class:`_PlateauWatch`,
:class:`_RangeCheck`) folded by :class:`EarlyStopping`; the checkpoint
payload keeps the reference's ``{"counters", "minimums"}`` layout so
resumes work across both.

Semantics notes, kept bug-for-bug compatible with the reference:
- an evaluation counts as "no improvement" when ``value >= best - delta``;
- unless ``cumulative_delta`` is set, a *worse* value replaces the
  recorded best (so the plateau window slides with the metric).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple


@dataclass
class _PlateauWatch:
    """Tracks one metric's no-improvement streak (condition 3)."""

    key: str
    patience: int
    delta: float = 0.0
    cumulative_delta: bool = False
    best: Optional[float] = None
    streak: int = 0

    def __post_init__(self) -> None:
        self.patience = int(self.patience)
        if self.patience < 1:
            raise ValueError(
                f"Argument patience for {self.key} should be positive integer."
            )
        if self.delta < 0.0:
            raise ValueError("Argument delta should not be a negative number.")

    def observe(self, value: float) -> Tuple[bool, Optional[str]]:
        """Feed one evaluation; returns (exhausted, progress_note)."""
        if self.best is None:
            self.best = value
            return False, None
        improved = value < self.best - self.delta
        if improved:
            self.best = value
            self.streak = 0
            return False, None
        # No meaningful improvement. In the non-cumulative mode the best
        # slides upward with a worse value, restarting the delta window.
        if not self.cumulative_delta and value > self.best:
            self.best = value
        self.streak += 1
        note = f"EarlyStopping: {self.streak} / {self.patience}"
        return self.streak >= self.patience, note


@dataclass
class _RangeCheck:
    """Stops when a metric leaves its allowed half-line (conditions 1+2)."""

    key: str
    threshold: float
    side: str  # "below" stops when value < threshold; "above" when value >

    def tripped(self, value: float) -> bool:
        if self.side == "below":
            return value < self.threshold
        return value > self.threshold

    def describe(self) -> str:
        relation = "smaller" if self.side == "below" else "larger"
        return f" {self.key} is {relation} than {self.threshold}"


class EarlyStopping:
    """Combine plateau + bound conditions over a metrics dict.

    Call with a mapping of metric values; returns
    ``(stop, stop_message, debug_message)`` like the reference. Reference
    parity: e3_layers/run/early_stopping.py:6-105 (C19).
    """

    def __init__(
        self,
        lower_bounds: dict = {},
        upper_bounds: dict = {},
        patiences: dict = {},
        delta: dict = {},
        cumulative_delta: bool = False,
    ):
        unmatched = set(delta) - set(patiences)
        if unmatched:
            key = sorted(unmatched)[0]
            raise ValueError(f"patience for {key} should be defined")

        self._watches: Dict[str, _PlateauWatch] = {
            key: _PlateauWatch(
                key=key,
                patience=pat,
                delta=float(dict(delta).get(key, 0.0)),
                cumulative_delta=cumulative_delta,
            )
            for key, pat in dict(patiences).items()
        }
        self._checks = [
            _RangeCheck(key=k, threshold=v, side="below")
            for k, v in dict(lower_bounds).items()
        ] + [
            _RangeCheck(key=k, threshold=v, side="above")
            for k, v in dict(upper_bounds).items()
        ]
        self.cumulative_delta = cumulative_delta

    # Attribute views kept for tests/checkpoints that poke at the
    # reference's internal dicts.
    @property
    def counters(self) -> Dict[str, int]:
        return {k: w.streak for k, w in self._watches.items()}

    @property
    def minimums(self) -> Dict[str, Optional[float]]:
        return {k: w.best for k, w in self._watches.items()}

    def __call__(self, metrics: Mapping) -> Tuple[bool, str, Optional[str]]:
        stop = False
        reasons = []
        debug: Optional[str] = None

        for key, watch in self._watches.items():
            exhausted, note = watch.observe(metrics[key])
            if note is not None:
                debug = note
            if exhausted:
                reasons.append(
                    f" {key} has not reduced for {watch.patience} epochs"
                )
                stop = True

        for check in self._checks:
            if check.tripped(metrics[check.key]):
                reasons.append(check.describe())
                stop = True

        return stop, "Early stopping:" + "".join(reasons), debug

    def state_dict(self) -> Dict[str, Dict]:
        return {"counters": self.counters, "minimums": self.minimums}

    def load_state_dict(self, state_dict: Mapping) -> None:
        for key, count in dict(state_dict["counters"]).items():
            if key in self._watches:
                self._watches[key].streak = int(count)
        for key, best in dict(state_dict["minimums"]).items():
            if key in self._watches:
                self._watches[key].best = best
