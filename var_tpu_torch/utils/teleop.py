"""Raw-terminal single-key input for manual control and data collection
(a copy of var_tpu/utils/teleop.py).

Puts the terminal in raw mode, reads exactly one character and restores
the settings. Falls back to line-based input() when stdin is not a TTY
(pipes, CI, scripted tests), so every manual mode stays drivable
headlessly.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional


def get_term_character() -> str:
    """Read ONE raw keypress from the controlling terminal."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old_settings = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        ch = sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old_settings)
    return ch


def stdin_is_tty() -> bool:
    try:
        return sys.stdin.isatty()
    except (AttributeError, ValueError):  # closed/replaced stdin
        return False


def make_input_fn(prompt: str = "> ",
                  single_key: Optional[bool] = None) -> Callable[[], str]:
    """Input source for the manual modes.

    single_key=None auto-selects: raw single-key reads on a real TTY,
    line-based input() otherwise. The returned callable always yields a
    string (possibly one char)."""
    if single_key is None:
        single_key = stdin_is_tty()
    if single_key:
        def read():
            ch = get_term_character()
            if ch in ("\x03", "\x04"):  # Ctrl-C / Ctrl-D in raw mode
                raise EOFError
            return ch

        return read
    return lambda: input(prompt)
