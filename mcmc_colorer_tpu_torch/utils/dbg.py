"""Interactive break-in debugger for running MCMC chains.

Counterpart of ``mcmc_colorer_tpu/utils/dbg.py`` (same commands, text
and injectable streams), itself the counterpart of the reference's
``src/utils/dbg.{h,cpp}``: a REPL attached
to the sequential chain that polls the terminal for ESC each iteration
(raw-tty ``stty``/``FIONREAD`` polling, dbg.cpp:41-67,88-97), breaks into
a print/edit shell over the chain's state vectors and supports live
editing of ε mid-run (dbg.cpp:358-381).

The attach point is the segment boundary of a stepped run
(``models/chain_api.SteppedMCMC.run``): between segments the debugger
polls for ESC; on break-in it runs the print/edit command set against
``SteppedMCMC.inspect`` and the state's tensors, and an epsilon edit
applies to every later sweep (the stepped API takes ε a segment).

Streams are injectable so the REPL is unit-testable without a tty; on a
real terminal ESC is detected with termios/FIONREAD exactly like the
reference.
"""

from __future__ import annotations

import os
import sys

_HELP = """commands (reference dbg.cpp print/edit shell):
  p <var>     print a variable: iteration | conflicts | violating |
              histogram | used | epsilon | taboo | free | colors [i [j]]
  e epsilon <value>   live-edit epsilon (applies from the next segment)
  c           continue the run
  q           abort the run (keeps the current coloring)
  h           this help
"""


def esc_pending(stream=None) -> bool:
    """Non-blocking check whether ESC is waiting on ``stream`` (default:
    stdin).  Real-tty rendition of check_F12keypress (dbg.cpp:88-97):
    FIONREAD tells how many bytes wait without consuming them."""
    stream = stream if stream is not None else sys.stdin
    try:
        fd = stream.fileno()
    except Exception:
        return False
    if fd < 0 or not os.isatty(fd):
        return False
    try:
        import fcntl
        import struct
        import termios

        buf = struct.pack("i", 0)
        n = struct.unpack("i", fcntl.ioctl(fd, termios.FIONREAD, buf))[0]
        if n <= 0:
            return False
        data = os.read(fd, n)
        return b"\x1b" in data
    except OSError:  # pragma: no cover - exotic terminals
        return False


class DebugAttach:
    """Print/edit REPL over a running `SteppedMCMC` chain.

    ``input``/``output`` default to the process tty; tests inject
    iterables/StringIO.  ``break_every`` forces a break-in at every
    segment boundary (the non-interactive analogue of holding ESC).
    """

    def __init__(
        self,
        input=None,
        output=None,
        break_every: bool = False,
    ) -> None:
        self._in = input
        self._out = output if output is not None else sys.stdout
        self.break_every = break_every
        self.epsilon: float | None = None  # live override (dbg.cpp:358-381)
        self.quit = False

    # -- polling -----------------------------------------------------------

    def pending(self) -> bool:
        if self.break_every:
            return True
        return esc_pending()

    # -- REPL ---------------------------------------------------------------

    def _readline(self) -> str:
        if self._in is None:
            try:
                return input("dbg> ")
            except EOFError:
                return "c"
        if hasattr(self._in, "readline"):
            line = self._in.readline()
            return line.strip() if line else "c"
        try:
            return next(self._in)
        except StopIteration:
            return "c"

    def _print(self, *parts) -> None:
        print(*parts, file=self._out)

    def break_in(self, stepped, state) -> None:
        """The stop_and_debug shell (dbg.cpp:113-158): print/edit until
        'c' (continue) or 'q' (abort)."""
        self._print(
            f"[dbg] paused at iteration {int(state.iteration)}, "
            f"{int(state.conflicts)} conflict edges; 'h' for help"
        )
        info = None
        while True:
            cmd = self._readline().split()
            if not cmd:
                continue
            op = cmd[0]
            if op == "c":
                return
            if op == "q":
                self.quit = True
                return
            if op == "h":
                self._print(_HELP)
                continue
            if op == "e":
                if len(cmd) == 3 and cmd[1] == "epsilon":
                    self.epsilon = float(cmd[2])
                    self._print(f"[dbg] epsilon <- {self.epsilon}")
                else:
                    self._print("usage: e epsilon <value>")
                continue
            if op != "p" or len(cmd) < 2:
                self._print("unknown command; 'h' for help")
                continue
            var = cmd[1]
            if var in (
                "violating", "histogram", "used", "free",
            ) and info is None:
                info = stepped.inspect(state)
            if var == "iteration":
                self._print(int(state.iteration))
            elif var == "conflicts":
                self._print(int(state.conflicts))
            elif var == "violating":
                self._print(info["violating_nodes"])
            elif var == "histogram":
                self._print(list(map(int, info["histogram"])))
            elif var == "used":
                self._print(info["used_colors"])
            elif var == "free":
                self._print(
                    f"min {info['free_colors_min']} "
                    f"max {info['free_colors_max']} "
                    f"avg {info['free_colors_avg']:.2f}"
                )
            elif var == "epsilon":
                self._print(
                    self.epsilon
                    if self.epsilon is not None
                    else stepped.params.epsilon
                )
            elif var == "taboo":
                self._print(int((state.taboo > 0).sum()))
            elif var == "colors":
                i = int(cmd[2]) if len(cmd) > 2 else 0
                j = int(cmd[3]) if len(cmd) > 3 else i + 10
                self._print(list(state.colors.cpu().numpy()[i:j]))
            else:
                self._print(f"unknown variable {var!r}; 'h' for help")
