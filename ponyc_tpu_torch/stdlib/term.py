"""ANSI terminal support — ≙ the reference's `packages/term/`:

- ``ANSI`` — escape-code constructors (≙ ansi.pony): colors, bright
  variants, bold/underline/blink/reverse, reset, cursor movement,
  erase, terminal size.
- ``ANSINotify`` / ``ANSITerm`` — interactive INPUT (≙ ansi_notify.pony,
  ansi_term.pony): an escape-sequence state machine over raw input
  bytes (CSI/SS3 arrows, home/end/insert/delete/page keys, fn keys,
  modifier encodings) dispatching to a notify object; wired to stdin
  through the bridge's fd subscription (≙ lang/stdfd.c feeding the
  stdin actor), or fed bytes directly (tests, embedders).
- ``ReadlineNotify`` / ``Readline`` — line editing (≙ readline.pony,
  readline_notify.pony): edit buffer with cursor movement, emacs-style
  control keys, history (optionally persisted), tab completion, and a
  Promise-driven prompt protocol: each finished line is handed to
  ``notify.apply(line, promise)``; fulfilling the promise sets the next
  prompt, rejecting it closes the terminal.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

from .promises import Promise

__all__ = ["ANSI", "ANSINotify", "ANSITerm", "Readline",
           "ReadlineNotify", "attach_stdin"]

_ESC = "\x1b["


class ANSI:
    """≙ ansi.pony ANSI primitive."""

    @staticmethod
    def up(n: int = 1) -> str:
        return f"{_ESC}{n}A" if n else ""

    @staticmethod
    def down(n: int = 1) -> str:
        return f"{_ESC}{n}B" if n else ""

    @staticmethod
    def right(n: int = 1) -> str:
        return f"{_ESC}{n}C" if n else ""

    @staticmethod
    def left(n: int = 1) -> str:
        return f"{_ESC}{n}D" if n else ""

    @staticmethod
    def cursor(x: int = 0, y: int = 0) -> str:
        return f"{_ESC}{y};{x}H"

    @staticmethod
    def clear() -> str:
        return f"{_ESC}2J"

    @staticmethod
    def erase() -> str:
        """Erase to the left of the cursor (≙ ansi.pony erase)."""
        return f"{_ESC}1K"

    @staticmethod
    def reset() -> str:
        return f"{_ESC}0m"

    @staticmethod
    def bold(state: bool = True) -> str:
        return f"{_ESC}1m" if state else f"{_ESC}22m"

    @staticmethod
    def underline(state: bool = True) -> str:
        return f"{_ESC}4m" if state else f"{_ESC}24m"

    @staticmethod
    def blink(state: bool = True) -> str:
        return f"{_ESC}5m" if state else f"{_ESC}25m"

    @staticmethod
    def reverse(state: bool = True) -> str:
        return f"{_ESC}7m" if state else f"{_ESC}27m"

    @staticmethod
    def size() -> Tuple[int, int]:
        """(rows, columns), env-overridable (≙ ansi.pony size)."""
        try:
            cols = int(os.environ.get("COLUMNS", ""))
            rows = int(os.environ.get("LINES", ""))
            return rows, cols
        except ValueError:
            ts = shutil.get_terminal_size()
            return ts.lines, ts.columns


class ANSINotify:
    """Receive parsed input from an ANSITerm (≙ ansi_notify.pony).
    Override the keys you care about; every hook defaults to no-op."""

    def apply(self, term: "ANSITerm", byte: int) -> None:
        """A plain input byte (printable or control)."""

    def up(self, ctrl=False, alt=False, shift=False) -> None: ...
    def down(self, ctrl=False, alt=False, shift=False) -> None: ...
    def left(self, ctrl=False, alt=False, shift=False) -> None: ...
    def right(self, ctrl=False, alt=False, shift=False) -> None: ...
    def delete(self, ctrl=False, alt=False, shift=False) -> None: ...
    def insert(self, ctrl=False, alt=False, shift=False) -> None: ...
    def home(self, ctrl=False, alt=False, shift=False) -> None: ...
    def end_key(self, ctrl=False, alt=False, shift=False) -> None: ...
    def page_up(self, ctrl=False, alt=False, shift=False) -> None: ...
    def page_down(self, ctrl=False, alt=False, shift=False) -> None: ...
    def fn_key(self, i, ctrl=False, alt=False, shift=False) -> None: ...
    def prompt(self, term: "ANSITerm", value: str) -> None: ...
    def size(self, rows: int, cols: int) -> None: ...
    def closed(self) -> None: ...


# Escape-parser states (≙ the _EscapeState primitives of ansi_term.pony;
# the machine itself is the standard VT100/xterm CSI/SS3 grammar).
_ES_NONE, _ES_START, _ES_SS3, _ES_CSI = range(4)

# CSI final letters → notify hook name (standard xterm keymap).
_CSI_LETTER = {ord("A"): "up", ord("B"): "down", ord("C"): "right",
               ord("D"): "left", ord("H"): "home", ord("F"): "end_key"}
# CSI `<n>~` numbers → hook name (vt220 keymap).
_CSI_TILDE = {1: "home", 2: "insert", 3: "delete", 4: "end_key",
              5: "page_up", 6: "page_down", 7: "home", 8: "end_key"}
# CSI `<n>~` function-key numbers (vt220: 11-15, 17-21, 23-24 → F1-F12).
_CSI_FN = {11: 1, 12: 2, 13: 3, 14: 4, 15: 5, 17: 6, 18: 7, 19: 8,
           20: 9, 21: 10, 23: 11, 24: 12}
# SS3 finals (application keypad): arrows, home/end, PF1-PF4.
_SS3 = {ord("A"): ("up", 0), ord("B"): ("down", 0),
        ord("C"): ("right", 0), ord("D"): ("left", 0),
        ord("H"): ("home", 0), ord("F"): ("end_key", 0),
        ord("P"): ("fn_key", 1), ord("Q"): ("fn_key", 2),
        ord("R"): ("fn_key", 3), ord("S"): ("fn_key", 4)}


class ANSITerm:
    """Parses ANSI escape codes from an input byte stream and dispatches
    to an ANSINotify (≙ the ANSITerm actor of ansi_term.pony).

    Feed bytes with ``apply(data)`` — from the bridge's stdin fd
    subscription (``attach_stdin``) or directly (tests, embedders).
    """

    def __init__(self, notify: ANSINotify, out=None):
        self._notify = notify
        self._out = out
        self._state = _ES_NONE
        self._params: List[int] = []
        self._num = 0
        self._have_num = False
        self._closed = False
        self._dispose_hooks: List = []
        self.size()

    def add_dispose_hook(self, fn) -> None:
        """Run `fn()` when this terminal is disposed, whatever the close
        path (EOF, ctrl-d, rejected prompt) — tty-mode restoration and
        fd unsubscription hang here (attach_stdin)."""
        self._dispose_hooks.append(fn)

    # -- input (≙ `be apply(data: Array[U8] iso)`) --
    def apply(self, data: bytes) -> None:
        if self._closed:
            return
        for b in bytes(data):
            self._byte(b)

    def _byte(self, b: int) -> None:
        if self._state == _ES_NONE:
            if b == 0x1B:
                self._state = _ES_START
                self._params, self._num, self._have_num = [], 0, False
            else:
                self._notify.apply(self, b)
            return
        if self._state == _ES_START:
            if b == ord("["):
                self._state = _ES_CSI
            elif b == ord("O"):
                self._state = _ES_SS3
            else:
                # Bare ESC followed by a plain byte: deliver both.
                self._state = _ES_NONE
                self._notify.apply(self, 0x1B)
                self._byte(b)
            return
        if self._state == _ES_SS3:
            self._state = _ES_NONE
            ent = _SS3.get(b)
            if ent is not None:
                name, fn = ent
                if name == "fn_key":
                    self._notify.fn_key(fn)
                else:
                    getattr(self._notify, name)()
            return
        # _ES_CSI: params are digits separated by ';', then a final byte.
        if ord("0") <= b <= ord("9"):
            self._num = self._num * 10 + (b - ord("0"))
            self._have_num = True
            return
        if b == ord(";"):
            self._params.append(self._num if self._have_num else 0)
            self._num, self._have_num = 0, False
            return
        if self._have_num:
            self._params.append(self._num)
        self._state = _ES_NONE
        # xterm modifier encoding: second parameter = 1 + bitfield
        # (1=shift, 2=alt, 4=ctrl).
        mod = (self._params[1] - 1) if len(self._params) > 1 else 0
        shift, alt, ctrl = bool(mod & 1), bool(mod & 2), bool(mod & 4)
        if b == ord("~"):
            n = self._params[0] if self._params else 0
            if n in _CSI_FN:
                self._notify.fn_key(_CSI_FN[n], ctrl, alt, shift)
            elif n in _CSI_TILDE:
                getattr(self._notify, _CSI_TILDE[n])(ctrl, alt, shift)
            return
        name = _CSI_LETTER.get(b)
        if name is not None:
            getattr(self._notify, name)(ctrl, alt, shift)

    # -- control surface (≙ ANSITerm.prompt/size/dispose) --
    def prompt(self, value: str) -> None:
        self._notify.prompt(self, value)

    def size(self) -> None:
        rows, cols = ANSI.size()
        self._notify.size(rows, cols)

    def dispose(self) -> None:
        if not self._closed:
            self._closed = True
            self._notify.closed()
            hooks, self._dispose_hooks = self._dispose_hooks, []
            for fn in hooks:
                try:
                    fn()
                except Exception:        # noqa: BLE001 — best-effort
                    pass

    @property
    def closed(self) -> bool:
        return self._closed


class ReadlineNotify:
    """Receives finished lines (≙ readline_notify.pony). The next
    prompt is set by fulfilling the promise; rejecting it stops input."""

    def apply(self, line: str, prompt: Promise) -> None:
        """Handle one finished line."""

    def tab(self, line: str) -> List[str]:
        """Return tab-completion possibilities for `line`."""
        return []


class Readline(ANSINotify):
    """Line editing, history, and tab completion (≙ readline.pony).

    Pass as the notify of an ANSITerm; write output (prompt echo,
    cursor redraws) to `out` (any .write(str)+.flush() object)."""

    def __init__(self, notify: ReadlineNotify, out, path: Optional[str]
                 = None, maxlen: int = 0):
        import codecs
        self._notify = notify
        self._out = out
        self._path = path
        self._maxlen = maxlen
        self._history: List[str] = []
        self._edit = ""
        self._cur_prompt = ""
        self._cur_line = 0        # history cursor
        self._pos = 0             # cursor position within _edit
        self._blocked = True      # begins blocked until a prompt is set
        # UTF-8 input arrives byte-at-a-time; buffer multi-byte
        # sequences so 'é' inserts ONE character with correct cursor
        # math (the reference round-trips raw bytes; a Python str edit
        # buffer must decode).
        self._u8 = codecs.getincrementaldecoder("utf-8")(errors="replace")
        self._load_history()

    # ---- ANSINotify hooks ----
    def apply(self, term: ANSITerm, byte: int) -> None:
        if self._blocked:
            return
        if byte == 0x01:                       # ctrl-a
            self.home()
        elif byte == 0x02:                     # ctrl-b
            self.left()
        elif byte == 0x04:                     # ctrl-d
            if not self._edit:
                self._out.write("\n")
                term.dispose()
            else:
                self.delete()
        elif byte == 0x05:                     # ctrl-e
            self.end_key()
        elif byte == 0x06:                     # ctrl-f
            self.right()
        elif byte in (0x08, 0x7F):             # ctrl-h / backspace
            self._backspace()
        elif byte == 0x09:                     # tab
            self._tab()
        elif byte in (0x0A, 0x0D):             # LF / CR
            self._dispatch(term)
        elif byte == 0x0B:                     # ctrl-k: kill to end
            self._edit = self._edit[:self._pos]
            self._refresh()
        elif byte == 0x0E:                     # ctrl-n
            self.down()
        elif byte == 0x10:                     # ctrl-p
            self.up()
        elif byte == 0x15:                     # ctrl-u: kill line
            self._edit, self._pos = "", 0
            self._refresh()
        elif byte >= 0x20:                     # printable: insert
            ch = self._u8.decode(bytes([byte]))
            if ch:                             # complete codepoint(s)
                self._edit = (self._edit[:self._pos] + ch
                              + self._edit[self._pos:])
                self._pos += len(ch)
                self._refresh()

    def up(self, ctrl=False, alt=False, shift=False) -> None:
        if self._cur_line > 0:
            self._cur_line -= 1
            self._edit = self._history[self._cur_line]
            self._pos = len(self._edit)
            self._refresh()

    def down(self, ctrl=False, alt=False, shift=False) -> None:
        if self._cur_line < len(self._history) - 1:
            self._cur_line += 1
            self._edit = self._history[self._cur_line]
        else:
            self._cur_line = len(self._history)
            self._edit = ""
        self._pos = len(self._edit)
        self._refresh()

    def left(self, ctrl=False, alt=False, shift=False) -> None:
        if self._pos > 0:
            self._pos -= 1
            self._refresh()

    def right(self, ctrl=False, alt=False, shift=False) -> None:
        if self._pos < len(self._edit):
            self._pos += 1
            self._refresh()

    def home(self, ctrl=False, alt=False, shift=False) -> None:
        self._pos = 0
        self._refresh()

    def end_key(self, ctrl=False, alt=False, shift=False) -> None:
        self._pos = len(self._edit)
        self._refresh()

    def delete(self, ctrl=False, alt=False, shift=False) -> None:
        if self._pos < len(self._edit):
            self._edit = (self._edit[:self._pos]
                          + self._edit[self._pos + 1:])
            self._refresh()

    def prompt(self, term: ANSITerm, value: str) -> None:
        self._cur_prompt = value
        self._blocked = False
        self._edit, self._pos = "", 0
        self._cur_line = len(self._history)
        self._refresh()

    def closed(self) -> None:
        self._save_history()
        self._notify_closed()

    def _notify_closed(self) -> None:
        closed = getattr(self._notify, "closed", None)
        if callable(closed):
            closed()

    # ---- internals (≙ readline.pony private fns) ----
    def _backspace(self) -> None:
        if self._pos > 0:
            self._edit = (self._edit[:self._pos - 1]
                          + self._edit[self._pos:])
            self._pos -= 1
            self._refresh()

    def _tab(self) -> None:
        options = list(self._notify.tab(self._edit[:self._pos]))
        if len(options) == 1:
            self._edit = options[0] + self._edit[self._pos:]
            self._pos = len(options[0])
            self._refresh()
        elif len(options) > 1:
            # Show the candidates, then redraw the line under them.
            self._out.write("\n" + "  ".join(options) + "\n")
            self._refresh()

    def _dispatch(self, term: ANSITerm) -> None:
        line = self._edit
        self._out.write("\n")
        self._blocked = True
        self._edit, self._pos = "", 0
        if line:
            if self._maxlen and len(self._history) >= self._maxlen:
                self._history.pop(0)
            self._history.append(line)
            self._cur_line = len(self._history)
        p = Promise()
        p.next(lambda new_prompt: self.prompt(term, str(new_prompt)),
               rejected=lambda _r: term.dispose())
        self._notify.apply(line, p)

    def _refresh(self) -> None:
        # Redraw: CR, erase line right of cursor start, prompt + edit,
        # then park the cursor (≙ readline.pony _refresh_line).
        move_back = len(self._edit) - self._pos
        out = ("\r" + f"{_ESC}0K" + self._cur_prompt + self._edit
               + (ANSI.left(move_back) if move_back else ""))
        self._out.write(out)
        flush = getattr(self._out, "flush", None)
        if callable(flush):
            flush()

    def _load_history(self) -> None:
        if not self._path:
            return
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                self._history = [ln.rstrip("\n") for ln in f
                                 if ln.rstrip("\n")]
            if self._maxlen:
                self._history = self._history[-self._maxlen:]
        except OSError:
            pass
        self._cur_line = len(self._history)

    def _save_history(self) -> None:
        if not self._path:
            return
        try:
            with open(self._path, "w", encoding="utf-8") as f:
                for ln in self._history:
                    f.write(ln + "\n")
        except OSError:
            pass


def attach_stdin(rt, term: ANSITerm, *, noisy: bool = True) -> int:
    """Wire an ANSITerm to real stdin through the runtime's bridge
    (≙ the stdin actor fed by lang/stdfd.c): raw bytes arrive at
    ``term.apply`` at host poll boundaries. Puts the tty in cbreak mode
    when stdin is a terminal — restored on EVERY close path (EOF,
    ctrl-d, rejected prompt, interpreter exit) via the terminal's
    dispose hooks + atexit. Returns the subscription id."""
    import atexit
    import sys

    bridge = rt.attach_bridge()
    fd = sys.stdin.fileno()
    restore = None
    if os.isatty(fd):
        try:
            import termios
            import tty
            old = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            done = []

            def restore():
                if not done:             # idempotent
                    done.append(True)
                    termios.tcsetattr(fd, termios.TCSADRAIN, old)
            atexit.register(restore)
        except (ImportError, OSError):
            restore = None

    def on_ready(_ev):
        try:
            data = os.read(fd, 1024)
        except OSError:
            data = b""
        if data:
            term.apply(data)
        else:
            term.dispose()

    sid = bridge.fd_callback(fd, on_ready, noisy=noisy)

    def cleanup():
        if restore is not None:
            restore()
        bridge.unsubscribe(sid)
    term.add_dispose_hook(cleanup)
    return sid


def _add_colors():
    base = {"black": 0, "red": 1, "green": 2, "yellow": 3, "blue": 4,
            "magenta": 5, "cyan": 6, "white": 7, "grey": None}

    for name, idx in base.items():
        if name == "grey":
            fg, bg = f"{_ESC}90m", f"{_ESC}100m"
        else:
            fg, bg = f"{_ESC}{30 + idx}m", f"{_ESC}{40 + idx}m"
        setattr(ANSI, name, staticmethod(lambda s=fg: s))
        setattr(ANSI, name + "_bg", staticmethod(lambda s=bg: s))
        if idx is not None:
            bright_fg = f"{_ESC}{90 + idx}m"
            bright_bg = f"{_ESC}{100 + idx}m"
            setattr(ANSI, "bright_" + name,
                    staticmethod(lambda s=bright_fg: s))
            setattr(ANSI, "bright_" + name + "_bg",
                    staticmethod(lambda s=bright_bg: s))


_add_colors()
