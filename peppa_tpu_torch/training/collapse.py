"""Embedding-collapse (constant-embedding saddle) detection.

Mirrors peppa_tpu/training/collapse.py.  When every clip maps to the same
embedding, every entry of the similarity matrix is equal, both hinges are
exactly `margin` everywhere, and every micro-batch's train loss pins at

    loss* = 2 * margin * (1 - 1/B)

Detection needs both conditions:

1. the model learned first: the best loss seen is below
   ``learned_frac * loss*`` (a random init also starts near loss*);
2. the loss is pinned: the last ``window`` micro-losses each lie within
   ``rel_tol * loss*`` of loss*, and their spread is below ``pin_tol`` (a
   collapsed model's loss does not depend on the batch).

A loss outside the band resets the window.
"""

from __future__ import annotations

from collections import deque


class CollapseDetector:
    """Streaming detector for the constant-embedding saddle.

    Parameters
    ----------
    margin, batch_size:
        The contrastive margin (config.margin) and MICRO-batch size
        (config.data.train.batch_size) — together they fix the saddle
        value ``2*margin*(1-1/B)`` the train loss pins at.
    window:
        Consecutive pinned micro-losses required to declare collapse.
    rel_tol:
        Half-width of the pin band around the saddle, relative to it.
    pin_tol:
        Maximum spread (max-min) across the window: collapsed losses are
        batch-independent and constant to ~1e-7; init-time losses near the
        saddle fluctuate orders of magnitude more.
    learned_frac:
        The model must first have achieved best_loss < learned_frac*saddle
        for detection to arm (rules out the random-init neighbourhood).
    """

    def __init__(self, margin: float, batch_size: int, window: int = 25,
                 rel_tol: float = 0.01, pin_tol: float = 1e-4,
                 learned_frac: float = 0.5):
        if batch_size < 2:
            raise ValueError("collapse detection needs batch_size >= 2")
        self.saddle = 2.0 * margin * (1.0 - 1.0 / batch_size)
        self.window = int(window)
        self.band = rel_tol * self.saddle
        self.pin_tol = pin_tol
        self.learned_threshold = learned_frac * self.saddle
        self.best = float("inf")
        self._pinned: deque = deque(maxlen=self.window)
        self.fired = False  # latched after the first detection

    def update(self, loss: float) -> bool:
        """Feed one micro-step train loss; True when collapse is detected.

        Latches: once fired, stays fired (callers act once; repeated True
        returns are harmless).
        """
        self.best = min(self.best, loss)
        if abs(loss - self.saddle) <= self.band:
            self._pinned.append(loss)
        else:
            self._pinned.clear()
        if (len(self._pinned) == self.window
                and self.best < self.learned_threshold
                and max(self._pinned) - min(self._pinned) <= self.pin_tol):
            self.fired = True
        return self.fired
