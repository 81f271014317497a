"""Input events for the interactive app.

The reference polls SDL keyboard/mouse state per frame
(``VoxelApp/main.cu:72-161``).  Headless accelerator hosts have no SDL, so input is
an event queue fed by (a) a raw-mode tty reader when stdin is a terminal,
or (b) a scripted sequence for reproducible fly-throughs/tests.
"""

from __future__ import annotations

import dataclasses
import os
import select
import sys
from typing import Iterable, List, Optional


@dataclasses.dataclass
class KeyEvent:
    key: str  # 'w','a','s','d','q','e','shift','quit', arrows: 'up','down','left','right'


class InputSource:
    def poll(self) -> List[KeyEvent]:
        raise NotImplementedError


class ScriptedInput(InputSource):
    """Replays a fixed per-frame key sequence (deterministic demos/tests)."""

    def __init__(self, frames: Iterable[List[str]]):
        self._frames = list(frames)
        self._i = 0

    def poll(self) -> List[KeyEvent]:
        if self._i >= len(self._frames):
            return [KeyEvent("quit")]
        keys = self._frames[self._i]
        self._i += 1
        return [KeyEvent(k) for k in keys]


class TtyInput(InputSource):
    """Non-blocking raw-mode tty reader (WASD/QE + arrows, ESC quits)."""

    _ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}
    # ESC disambiguation grace: over a laggy ssh/pty the tail of an arrow
    # sequence ("\x1b" then "[A") can land a packet later than the ESC
    # byte.  A zero-timeout peek would misread that as a bare ESC and
    # quit the app on a camera turn; 25 ms is imperceptible per frame and
    # far above intra-sequence jitter.  Only the ESC path waits — the
    # outer poll loop stays non-blocking.
    _ESC_GRACE_S = 0.025

    def __init__(self):
        import termios, tty  # noqa: PLC0415

        self._fd = sys.stdin.fileno()
        self._old = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)

    # every key voxel_app handles: move + fly, speed boost 'b', break/place
    # 'f'/'g' (apps/voxel_app.py:210-264)
    _KEYS = "wasdqebfg"

    def _key_event(self, ch: str) -> Optional[KeyEvent]:
        if len(ch) == 1 and ch.lower() in self._KEYS:
            return KeyEvent(ch.lower())
        if ch in ("X", "x"):
            return KeyEvent("quit")
        return None

    def poll(self) -> List[KeyEvent]:
        events: List[KeyEvent] = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = os.read(self._fd, 1).decode(errors="ignore")
            if ch == "\x1b":  # ESC: bare, or the start of an escape sequence
                if not select.select([sys.stdin], [], [], self._ESC_GRACE_S)[0]:
                    events.append(KeyEvent("quit"))
                    continue
                c1 = os.read(self._fd, 1).decode(errors="ignore")
                if c1 != "[":
                    # ESC followed by an ordinary key (e.g. buffered 'w'
                    # autorepeat): the ESC still quits, and the key is NOT
                    # swallowed as a sequence tail
                    events.append(KeyEvent("quit"))
                    ev = self._key_event(c1)
                    if ev:
                        events.append(ev)
                    continue
                # CSI sequence: read up to the final byte (0x40-0x7E);
                # parameter/intermediate bytes (0x20-0x3F) may precede it
                seq = ""
                while select.select([sys.stdin], [], [], self._ESC_GRACE_S)[0]:
                    c = os.read(self._fd, 1).decode(errors="ignore")
                    seq += c
                    if c and "\x40" <= c <= "\x7e":
                        break
                if seq in self._ARROWS:
                    events.append(KeyEvent(self._ARROWS[seq]))
                # any other CSI (PgUp 5~, F-keys, ...) is ignored — it
                # neither quits nor eats unrelated buffered keys
                continue
            ev = self._key_event(ch)
            if ev:
                events.append(ev)
        return events

    def close(self):
        import termios  # noqa: PLC0415

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)


def best_input(scripted: Optional[Iterable[List[str]]] = None) -> InputSource:
    if scripted is not None:
        return ScriptedInput(scripted)
    if sys.stdin.isatty():
        try:
            return TtyInput()
        except Exception:
            pass
    return ScriptedInput([])
