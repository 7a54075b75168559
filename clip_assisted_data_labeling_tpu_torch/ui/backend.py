"""Labelling display backends (port of the JAX package's ``ui/backend.py``).
The labelling loop talks to a ``LabelBackend``, so the same logic drives a
real OpenCV window, or a headless scripted backend in tests and CI.

Key protocol (normalized): '0'-'9' label keys, 'left'/'right' navigation,
'quit'. Backends translate their raw events into these.
"""
from __future__ import annotations

import abc

import numpy as np

# raw keycodes accepted by the OpenCV backend: arrows on Linux GTK (81/83, the
# reference's hardcoded values) plus common alternatives so other platforms work
_LEFT_CODES = {81, 2, 65361}
_RIGHT_CODES = {83, 3, 65363}


class LabelBackend(abc.ABC):
    @abc.abstractmethod
    def show(self, image: np.ndarray, progress: float) -> str:
        """Display the annotated frame, block for one key, return a normalized
        key: '0'..'9', 'left', 'right', 'quit', or 'noop'."""

    def close(self) -> None:  # pragma: no cover - trivial
        pass


class OpenCVBackend(LabelBackend):
    """A cv2 window (needs cv2 and a display)."""

    def __init__(self, window_name: str = "image"):
        self.window_name = window_name

    def show(self, image: np.ndarray, progress: float) -> str:
        import cv2

        cv2.namedWindow(self.window_name, cv2.WINDOW_AUTOSIZE)
        cv2.imshow(self.window_name, image)
        key = cv2.waitKey(0)
        if key == -1 and cv2.getWindowProperty(
            self.window_name, cv2.WND_PROP_VISIBLE
        ) < 1:
            # the user closed the window: treat as quit — returning 'noop'
            # would make the label loop respawn the window forever
            return "quit"
        if ord("0") <= key <= ord("9"):
            return chr(key)
        if key in (ord("q"), 27):
            return "quit"
        if key in _LEFT_CODES:
            return "left"
        if key in _RIGHT_CODES:
            return "right"
        return "noop"

    def close(self) -> None:
        import cv2

        cv2.destroyAllWindows()


class HeadlessBackend(LabelBackend):
    """Replays a scripted key sequence; records every frame it was shown
    (``shown``: shape and progress) and, through the labelling loop's
    ``on_image`` hook, the uuid of each (``shown_uuids``)."""

    def __init__(self, keys: list[str]):
        self.keys = list(keys)
        self.shown: list[tuple[tuple, float]] = []
        self.shown_uuids: list[str] = []
        self._i = 0

    def on_image(self, uuid: str) -> None:
        self.shown_uuids.append(uuid)

    def show(self, image: np.ndarray, progress: float) -> str:
        self.shown.append((image.shape, progress))
        if self._i >= len(self.keys):
            return "quit"
        key = self.keys[self._i]
        self._i += 1
        return key


class OracleBackend(LabelBackend):
    """Labels each shown image from a uuid→label mapping, stopping after
    ``budget`` labels. The labelling loop announces the upcoming image through
    the optional ``on_image(uuid)`` hook (pipeline/label.py) before ``show``.

    The oracle labeler for closed-loop active-learning evaluation: it plays
    the human in the label→train→predict→re-sort cycle, so the acquisition
    policies' label efficiency is measurable."""

    def __init__(self, labels: dict[str, float], budget: int,
                 skip: set[str] | None = None):
        self.labels = labels
        self.budget = budget
        # uuids labeled in EARLIER sessions: navigate past them ('right')
        # instead of re-labeling — re-labels would silently eat the budget
        # (the loop stops auto-skipping labeled images after the first show,
        # mirroring the reference's navigation semantics, _3:174-178)
        self.skip = set(skip or ())
        self.labeled: list[str] = []
        self._uuid: str | None = None
        self._seen_since_label: set[str] = set()

    def on_image(self, uuid: str) -> None:
        self._uuid = uuid

    def show(self, image: np.ndarray, progress: float) -> str:
        u = self._uuid
        if len(self.labeled) >= self.budget or u not in self.labels:
            return "quit"
        if u in self._seen_since_label:
            return "quit"  # wrapped around: nothing left to label
        self._seen_since_label.add(u)
        if u in self.skip or u in self.labeled:
            return "right"
        key = int(round(self.labels[u] * 10))
        self.labeled.append(u)
        self._seen_since_label.clear()
        return str(min(9, max(0, key)))
